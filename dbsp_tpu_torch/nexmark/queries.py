"""Nexmark queries as circuit builders — q3, q4, q8 and q15 of
``dbsp_tpu/nexmark/queries.py``. A builder takes the three relation
streams (persons, auctions, bids) and returns the query's output stream.
Integer division is floor division on int64, as ``jnp``'s ``//`` is."""

from __future__ import annotations

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.nexmark import model as M
from dbsp_tpu_torch.operators.aggregate import Max
# Count/Average take the linear path (delta segment sums, no input trace)
from dbsp_tpu_torch.operators.aggregate_linear import LinearAverage as Average
from dbsp_tpu_torch.operators.aggregate_linear import LinearCount as Count

I64 = torch.int64
I32 = torch.int32

# State codes standing in for the reference's 'OR','ID','CA' literals
# (states are dictionary-encoded by the generator).
Q3_STATES = (0, 1, 2)
Q3_CATEGORY = 10


def q3(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Who is selling in OR/ID/CA in category 10? filter(persons by state)
    joined with filter(auctions by category) on seller -> (name, city,
    state), keyed by auction id."""
    sellers = persons.filter_rows(
        lambda k, v: (v[M.P_STATE] == Q3_STATES[0])
        | (v[M.P_STATE] == Q3_STATES[1]) | (v[M.P_STATE] == Q3_STATES[2]),
        name="q3-sellers")
    cat = auctions.filter_rows(
        lambda k, v: v[M.A_CATEGORY] == Q3_CATEGORY, name="q3-category")
    # re-key auctions by seller (person id)
    by_seller = cat.index_by(
        lambda k, v: (v[M.A_SELLER],), M.PERSON_KEY,
        val_fn=lambda k, v: (k[0],), val_dtypes=(I64,),
        name="q3-by-seller")
    return sellers.join_index(
        by_seller,
        lambda k, pv, av: ((av[0],), (pv[0], pv[1], pv[2])),
        [I64], [I32, I32, I32], name="q3-join")


Q8_WINDOW_MS = 10_000


def q8(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Monitor new users: persons who created an auction in the same
    tumbling 10 s window they registered in. The window start is a join
    key component. Output: (person_id, window_start, name)."""
    p_keyed = persons.index_by(
        lambda k, v: (k[0], (v[M.P_DATE] // Q8_WINDOW_MS) * Q8_WINDOW_MS),
        (I64, I64), val_fn=lambda k, v: (v[M.P_NAME],), val_dtypes=(I32,),
        name="q8-persons")
    a_keyed = auctions.index_by(
        lambda k, v: (v[M.A_SELLER],
                      (v[M.A_DATE] // Q8_WINDOW_MS) * Q8_WINDOW_MS),
        (I64, I64), val_fn=lambda k, v: (), val_dtypes=(),
        name="q8-auctions")
    joined = p_keyed.join_index(
        a_keyed, lambda k, pv, av: (k, (pv[0],)), (I64, I64), (I32,),
        name="q8-join")
    return joined.distinct()


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


DAY_MS = 86_400_000


def q15(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Distinct bidders per day: (day, n_distinct)."""
    day_bidder = bids.map_rows(
        lambda k, v: ((v[M.B_DATE] // DAY_MS, v[M.B_BIDDER]), ()),
        (I64, I64), (), name="q15-daybidder")
    uniq = day_bidder.distinct()
    by_day = uniq.index_by(lambda k, v: (k[0],), (I64,),
                           val_fn=lambda k, v: (k[1],), val_dtypes=(I64,),
                           name="q15-by-day")
    return by_day.aggregate(Count(), name="q15-count")
