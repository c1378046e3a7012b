"""Nexmark queries as circuit builders — q4 of
``dbsp_tpu/nexmark/queries.py``. A builder takes the three relation
streams (persons, auctions, bids) and returns the query's output stream."""

from __future__ import annotations

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.nexmark import model as M
from dbsp_tpu_torch.operators.aggregate import Max
# Average takes the linear path (delta segment sums, no input trace)
from dbsp_tpu_torch.operators.aggregate_linear import LinearAverage as Average

I64 = torch.int64


def q4(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Average final (max) bid price per category over closed auctions:
    bids within [auction.date_time, auction.expires] joined on auction id
    -> max price per (auction, category) -> average per category."""
    by_auction = auctions.index_by(
        lambda k, v: (k[0],), M.AUCTION_KEY,
        val_fn=lambda k, v: (v[M.A_CATEGORY], v[M.A_DATE], v[M.A_EXPIRES]),
        val_dtypes=(I64, I64, I64), name="q4-auctions")
    joined = bids.join_index(
        by_auction,
        lambda k, bv, av: (
            (k[0], av[0]),
            (bv[M.B_PRICE], bv[M.B_DATE], av[1], av[2])),
        [I64, I64], [I64, I64, I64, I64], name="q4-join")
    in_window = joined.filter_rows(
        lambda k, v: (v[1] >= v[2]) & (v[1] <= v[3]), name="q4-window")
    # max price per (auction, category)
    per_auction = in_window.map_rows(
        lambda k, v: (k, (v[0],)), (I64, I64), (I64,),
        name="q4-price").aggregate(Max(0), name="q4-max")
    # average of those maxima per category
    by_category = per_auction.index_by(
        lambda k, v: (k[1],), (I64,), val_fn=lambda k, v: (v[0],),
        val_dtypes=(I64,), name="q4-by-category")
    return by_category.aggregate(Average(0), name="q4-avg")
