"""Nexmark event generator — vectorized, columnar, deterministic; a copy
of ``dbsp_tpu/nexmark/generator.py`` (pure numpy), so the port's event
stream equals the reference's for the same seed.

Out of every 50 consecutive events 1 is a person, 3 are auctions and 46
are bids; ids are dense and monotone; event time advances at a configured
rate; bids prefer recent ("hot") auctions and bidders. Every event is a
pure function of (seed, event index): draw j of event i is
splitmix64(seed, i*8 + j), so any partition of [n0, n1) into batches gives
the same events.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from dbsp_tpu_torch.nexmark import model as M


def _mix64(seed: int, x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 counters — the per-event RNG."""
    z = x.astype(np.uint64) + np.uint64((seed * 0x9E3779B97F4A7C15) % 2**64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Mirrors the knobs of the reference bench config (nexmark/src/config.rs)."""

    seed: int = 1
    base_time_ms: int = 1_651_000_000_000  # arbitrary fixed epoch start
    first_event_rate: int = 10_000_000     # events/sec of *event time*
    hot_auction_ratio: float = 0.85        # P(bid goes to a recent auction)
    hot_bidder_ratio: float = 0.85
    hot_window: int = 100                  # "recent" = last N auctions/persons
    num_channels: int = 16
    num_name_codes: int = 512
    num_city_codes: int = 64
    num_state_codes: int = 50
    auction_expire_min_ms: int = 1_000
    auction_expire_max_ms: int = 60_000


class NexmarkGenerator:
    """Columnar batch generator over a half-open event-index range."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig()):
        self.cfg = cfg

    # -- index arithmetic (pure) -------------------------------------------
    @staticmethod
    def _epoch_offset(n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return (n // M.PROPORTION_DENOMINATOR,
                n % M.PROPORTION_DENOMINATOR)

    @staticmethod
    def person_count(n: int) -> int:
        """Number of person events among events [0, n)."""
        ep, off = divmod(n, M.PROPORTION_DENOMINATOR)
        return ep + min(off, M.PERSON_PROPORTION)

    @staticmethod
    def auction_count(n: int) -> int:
        ep, off = divmod(n, M.PROPORTION_DENOMINATOR)
        extra = min(max(off - M.PERSON_PROPORTION, 0), M.AUCTION_PROPORTION)
        return ep * M.AUCTION_PROPORTION + extra

    def timestamps(self, n: np.ndarray) -> np.ndarray:
        step_ns = 1_000_000_000 // self.cfg.first_event_rate
        return self.cfg.base_time_ms + (n.astype(np.int64) * step_ns) // 1_000_000


    # -- batch generation ---------------------------------------------------
    def generate(self, n0: int, n1: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Columns for events [n0, n1), split per relation.

        Returns {"persons": {...}, "auctions": {...}, "bids": {...}} where
        each inner dict maps column name -> numpy array. Deterministic in
        the seed and independent of the partitioning into batches: the
        randomness is counter-based, keyed by absolute event index.
        """
        n = np.arange(n0, n1, dtype=np.int64)
        ep, off = self._epoch_offset(n)
        ts = self.timestamps(n)
        is_person = off < M.PERSON_PROPORTION
        is_auction = (~is_person) & (off < M.PERSON_PROPORTION +
                                     M.AUCTION_PROPORTION)
        is_bid = ~is_person & ~is_auction

        # Stateless counter-based randomness: draw j for absolute event index
        # i is splitmix64(seed, i*8+j) — batch-invariant by construction (any
        # [n0,n1) partitioning yields identical events) and embarrassingly
        # parallel, unlike a sequential RNG stream.
        r32 = np.stack([_mix64(self.cfg.seed, n * 8 + j) >> np.uint64(33)
                        for j in range(5)]).astype(np.int64)

        out = {
            "persons": self._persons(n[is_person], ep[is_person],
                                     ts[is_person], r32[:, is_person]),
            "auctions": self._auctions(n[is_auction], ep[is_auction],
                                       off[is_auction], ts[is_auction],
                                       r32[:, is_auction]),
            "bids": self._bids(n[is_bid], ts[is_bid], r32[:, is_bid]),
        }
        return out

    def _persons(self, n, ep, ts, r):
        pid = M.FIRST_PERSON_ID + ep  # one person per epoch, dense ids
        return {
            "id": pid,
            "name": (r[0] % self.cfg.num_name_codes).astype(np.int32),
            "city": (r[1] % self.cfg.num_city_codes).astype(np.int32),
            "state": (r[2] % self.cfg.num_state_codes).astype(np.int32),
            "email": (r[3] % self.cfg.num_name_codes).astype(np.int32),
            "date_time": ts,
        }

    def _auctions(self, n, ep, off, ts, r):
        aid = (M.FIRST_AUCTION_ID + ep * M.AUCTION_PROPORTION +
               (off - M.PERSON_PROPORTION))
        # seller: usually a recent person, sometimes any existing one
        max_person = np.maximum(ep, 0)  # persons 0..ep exist (epoch ep just added one)
        hot = (r[0] % 1000) < int(self.cfg.hot_bidder_ratio * 1000)
        recent = np.maximum(max_person - self.cfg.hot_window, 0)
        seller_idx = np.where(
            hot, recent + r[1] % np.maximum(max_person - recent + 1, 1),
            r[1] % np.maximum(max_person + 1, 1))
        price0 = 1 + (r[2] % 10_000)
        span = self.cfg.auction_expire_max_ms - self.cfg.auction_expire_min_ms
        return {
            "id": aid,
            "item": (r[3] % self.cfg.num_name_codes).astype(np.int32),
            "seller": M.FIRST_PERSON_ID + seller_idx,
            "category": M.FIRST_CATEGORY_ID + r[4] % M.NUM_CATEGORIES,
            "initial_bid": price0,
            "reserve": price0 + (r[2] >> 16) % 10_000,
            "date_time": ts,
            "expires": ts + self.cfg.auction_expire_min_ms + r[0] % span,
        }

    def _bids(self, n, ts, r):
        ep = n // M.PROPORTION_DENOMINATOR
        max_auction = np.maximum((ep + 1) * M.AUCTION_PROPORTION - 1, 0)
        max_person = ep
        hot_a = (r[0] % 1000) < int(self.cfg.hot_auction_ratio * 1000)
        recent_a = np.maximum(max_auction - self.cfg.hot_window, 0)
        auction_idx = np.where(
            hot_a, recent_a + r[1] % np.maximum(max_auction - recent_a + 1, 1),
            r[1] % np.maximum(max_auction + 1, 1))
        hot_b = (r[2] % 1000) < int(self.cfg.hot_bidder_ratio * 1000)
        recent_b = np.maximum(max_person - self.cfg.hot_window, 0)
        bidder_idx = np.where(
            hot_b, recent_b + r[3] % np.maximum(max_person - recent_b + 1, 1),
            r[3] % np.maximum(max_person + 1, 1))
        # log-uniform price in [1, 10^7)
        price = np.exp(np.log(10_000_000) * ((r[4] % 65536) / 65536.0))
        return {
            "auction": M.FIRST_AUCTION_ID + auction_idx,
            "bidder": M.FIRST_PERSON_ID + bidder_idx,
            "price": np.maximum(price.astype(np.int64), 1),
            "channel": (r[0] % self.cfg.num_channels).astype(np.int32),
            "date_time": ts,
        }

    # -- circuit feeding ----------------------------------------------------
    def feed(self, handles, n0: int, n1: int) -> None:
        """Push events [n0, n1) into the (persons, auctions, bids) input
        handles as batches on the handles' device."""
        from dbsp_tpu_torch.zset.batch import Batch

        cols = self.generate(n0, n1)
        hp, ha, hb = handles
        # persons/auctions arrive sorted by their dense monotone id with
        # weight 1 — already consolidated; bids are keyed by (random)
        # auction id and are consolidated (sorted) here
        p = cols["persons"]
        if len(p["id"]):
            hp.push_batch(Batch.from_columns(
                [p["id"]], [p["name"], p["city"], p["state"], p["email"],
                            p["date_time"]],
                np.ones(len(p["id"]), np.int64), device=hp.device,
                consolidated=True), consolidated=True)
        a = cols["auctions"]
        if len(a["id"]):
            ha.push_batch(Batch.from_columns(
                [a["id"]], [a["item"], a["seller"], a["category"],
                            a["initial_bid"], a["reserve"], a["date_time"],
                            a["expires"]],
                np.ones(len(a["id"]), np.int64), device=ha.device,
                consolidated=True), consolidated=True)
        b = cols["bids"]
        if len(b["auction"]):
            hb.push_batch(Batch.from_columns(
                [b["auction"]], [b["bidder"], b["price"], b["channel"],
                                 b["date_time"]],
                np.ones(len(b["auction"]), np.int64), device=hb.device),
                consolidated=True)
