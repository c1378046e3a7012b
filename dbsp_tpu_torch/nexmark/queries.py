"""Nexmark queries as circuit builders — q0-q9 and q12-q22 of
``dbsp_tpu/nexmark/queries.py``. A builder takes the three relation
streams (persons, auctions, bids) and returns the query's output stream.
Integer division is floor division on int64, as ``jnp``'s ``//`` is."""

from __future__ import annotations

import dataclasses

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.nexmark import model as M
from dbsp_tpu_torch.operators.aggregate import Max, Min
# Count/Average take the linear path (delta segment sums, no input trace)
from dbsp_tpu_torch.operators.aggregate_linear import LinearAggregator
from dbsp_tpu_torch.operators.aggregate_linear import LinearAverage as Average
from dbsp_tpu_torch.operators.aggregate_linear import LinearCount as Count

I64 = torch.int64
I32 = torch.int32


def q0(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Passthrough: the engine's own overhead."""
    return bids.map_rows(lambda k, v: (k, v), M.BID_KEY, M.BID_VALS,
                         name="q0", preserves_order=True)


def q1(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Currency conversion, dollars to euros: price * 908 // 1000 (integer
    milli-euros keep the Z-set exact)."""
    def conv(k, v):
        bidder, price, channel, ts = v
        return k, (bidder, price * 908 // 1000, channel, ts)

    return bids.map_rows(conv, M.BID_KEY, M.BID_VALS, name="q1",
                         preserves_order=True)


def q2(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Bids on a sampled set of auctions (auction % 123 == 0), projected to
    (auction, price)."""
    filt = bids.filter_rows(lambda k, v: k[0] % 123 == 0, name="q2-filter")
    return filt.map_rows(lambda k, v: (k, (v[M.B_PRICE],)),
                         M.BID_KEY, (I64,), name="q2-project")

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


Q5_WINDOW_MS = 10_000
Q5_HOP_MS = 2_000
Q5_RETAIN_MS = 4 * Q5_WINDOW_MS  # completed windows linger this long


def q5(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Hot items: the auctions with the most bids in each hopping window
    (10 s windows, a 2 s hop). A bid belongs to exactly window / hop = 5
    windows, so the hop is a static flat_map of fan-out 5. A watermark on
    bid time drives monotone bounds: windows that start below watermark -
    retention are retracted and their trace state is truncated (window
    GC). Output: (window_start, auction) for the auctions whose bid count
    equals the window's maximum."""
    fanout = Q5_WINDOW_MS // Q5_HOP_MS

    def assign(k, v):
        ts = v[M.B_DATE]
        first = (ts // Q5_HOP_MS) * Q5_HOP_MS - (fanout - 1) * Q5_HOP_MS
        starts = torch.stack([first + i * Q5_HOP_MS for i in range(fanout)])
        auction = k[0].expand(starts.shape)
        keep = torch.ones(starts.shape, dtype=torch.bool,
                          device=starts.device)
        return (starts, auction), (), keep

    per_window = bids.flat_map_rows(assign, fanout, (I64, I64), (),
                                    name="q5-windows")
    wm = bids.watermark_monotonic(lambda k, v: v[M.B_DATE], lateness=0)
    bounds = wm.apply(
        lambda w: None if w is None else (w - Q5_RETAIN_MS, 1 << 62),
        name="q5-bounds")
    per_window = per_window.window(bounds, gc=True)
    counts = per_window.aggregate(Count(), name="q5-count")
    # counts: key (window, auction), value (n); the largest n per window
    by_window = counts.index_by(
        lambda k, v: (k[0],), (I64,),
        val_fn=lambda k, v: (k[1], v[0]), val_dtypes=(I64, I64),
        name="q5-by-window", preserves_first_key=True)
    maxes = by_window.aggregate(Max(1), name="q5-max")
    hot = by_window.join_index(
        maxes, lambda k, cv, mv: (k, (cv[0], cv[1], mv[0])),
        (I64,), (I64, I64, I64), name="q5-join", preserves_first_key=True)
    winners = hot.filter_rows(lambda k, v: v[1] == v[2], name="q5-winners")
    return winners.map_rows(lambda k, v: ((k[0], v[0]), ()), (I64, I64),
                            (), name="q5-project", preserves_first_key=True)


Q7_WINDOW_MS = 10_000


def q7(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Highest bid of the latest completed tumbling window: a watermark on
    bid time drives monotone bounds, the window keeps the bids of the last
    complete period, and a Max reduces them. The bounds floor the
    watermark (``//`` floors on tensors too, below zero included).
    Output: (window_end, max_price)."""
    wm = bids.watermark_monotonic(lambda k, v: v[M.B_DATE], lateness=0)

    def to_bounds(w):
        if w is None:
            return None
        end = (w // Q7_WINDOW_MS) * Q7_WINDOW_MS
        return (end - Q7_WINDOW_MS, end)

    bounds = wm.apply(to_bounds, name="q7-bounds")
    by_time = bids.index_by(
        lambda k, v: (v[M.B_DATE],), (I64,),
        val_fn=lambda k, v: (v[M.B_PRICE],), val_dtypes=(I64,),
        name="q7-by-time")
    windowed = by_time.window(bounds)
    # every row of the one-period window shares its end: key by it
    keyed = windowed.map_rows(
        lambda k, v: (((k[0] // Q7_WINDOW_MS) * Q7_WINDOW_MS
                       + Q7_WINDOW_MS,), (v[0],)),
        (I64,), (I64,), name="q7-rekey")
    return keyed.aggregate(Max(0), name="q7-max")


Q8_WINDOW_MS = 10_000


def q8(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Monitor new users: persons who created an auction in the same
    tumbling 10 s window they registered in. The window start is a join
    key component. Output: (person_id, window_start, name)."""
    p_keyed = persons.index_by(
        lambda k, v: (k[0], (v[M.P_DATE] // Q8_WINDOW_MS) * Q8_WINDOW_MS),
        (I64, I64), val_fn=lambda k, v: (v[M.P_NAME],), val_dtypes=(I32,),
        name="q8-persons", preserves_first_key=True)
    a_keyed = auctions.index_by(
        lambda k, v: (v[M.A_SELLER],
                      (v[M.A_DATE] // Q8_WINDOW_MS) * Q8_WINDOW_MS),
        (I64, I64), val_fn=lambda k, v: (), val_dtypes=(),
        name="q8-auctions")
    joined = p_keyed.join_index(
        a_keyed, lambda k, pv, av: (k, (pv[0],)), (I64, I64), (I32,),
        name="q8-join", preserves_first_key=True)
    return joined.distinct()


def q4(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Average final (max) bid price per category over closed auctions:
    bids within [auction.date_time, auction.expires] joined on auction id
    -> max price per (auction, category) -> average per category."""
    by_auction = auctions.index_by(
        lambda k, v: (k[0],), M.AUCTION_KEY,
        val_fn=lambda k, v: (v[M.A_CATEGORY], v[M.A_DATE], v[M.A_EXPIRES]),
        val_dtypes=(I64, I64, I64), name="q4-auctions",
        preserves_first_key=True)
    joined = bids.join_index(
        by_auction,
        lambda k, bv, av: (
            (k[0], av[0]),
            (bv[M.B_PRICE], bv[M.B_DATE], av[1], av[2])),
        [I64, I64], [I64, I64, I64, I64], name="q4-join",
        preserves_first_key=True)
    in_window = joined.filter_rows(
        lambda k, v: (v[1] >= v[2]) & (v[1] <= v[3]), name="q4-window")
    # max price per (auction, category)
    per_auction = in_window.map_rows(
        lambda k, v: (k, (v[0],)), (I64, I64), (I64,),
        name="q4-price", preserves_first_key=True).aggregate(
            Max(0), name="q4-max")
    # average of those maxima per category
    by_category = per_auction.index_by(
        lambda k, v: (k[1],), (I64,), val_fn=lambda k, v: (v[0],),
        val_dtypes=(I64,), name="q4-by-category")
    return by_category.aggregate(Average(0), name="q4-avg")


# ---------------------------------------------------------------------------
# q6 / q9: winning bids (a join, an in-window filter, a per-auction top-1
# with a tie-break) and per-seller averages (a top-10 by close time)
# ---------------------------------------------------------------------------


def _winning_bids(auctions: Stream, bids: Stream) -> Stream:
    """(auction) -> (price, -date_time, bidder, seller, expires) of the
    winning in-window bid of each auction: the highest price, the earliest
    of equal prices. The tie-break is the ranking on (price, -date_time):
    its lexicographic top-1 takes the largest price, then the smallest
    time."""
    by_auction = auctions.index_by(
        lambda k, v: (k[0],), M.AUCTION_KEY,
        val_fn=lambda k, v: (v[M.A_SELLER], v[M.A_DATE], v[M.A_EXPIRES]),
        val_dtypes=(I64, I64, I64), name="q9-auctions",
        preserves_first_key=True)
    joined = bids.join_index(
        by_auction,
        lambda k, bv, av: (
            (k[0],),
            (bv[M.B_PRICE], -bv[M.B_DATE], bv[M.B_BIDDER], av[0],
             bv[M.B_DATE], av[1], av[2])),
        (I64,), (I64, I64, I64, I64, I64, I64, I64), name="q9-join",
        preserves_first_key=True)
    in_window = joined.filter_rows(
        lambda k, v: (v[4] >= v[5]) & (v[4] <= v[6]), name="q9-window")
    ranked = in_window.map_rows(
        lambda k, v: (k, (v[0], v[1], v[2], v[3], v[6])),
        (I64,), (I64, I64, I64, I64, I64), name="q9-rank")
    return ranked.topk(1, largest=True, name="q9-top1")


def q9(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Winning bid of each auction: (auction, price, ts, bidder)."""
    return _winning_bids(auctions, bids).map_rows(
        lambda k, v: (k, (v[0], -v[1], v[2])),
        (I64,), (I64, I64, I64), name="q9-project",
        preserves_first_key=True)


def q6(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Average winning price of each seller's last 10 closed auctions:
    winning bids -> per-seller top-10 by expiry -> average. Output:
    (seller, avg_price)."""
    winners = _winning_bids(auctions, bids)
    by_seller = winners.map_rows(
        lambda k, v: ((v[3],), (v[4], k[0], v[0])),
        (I64,), (I64, I64, I64), name="q6-by-seller")
    last10 = by_seller.topk(10, largest=True, name="q6-last10")
    prices = last10.map_rows(lambda k, v: (k, (v[2],)), (I64,), (I64,),
                             name="q6-prices")
    return prices.aggregate(Average(0), name="q6-avg")


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


Q16_RANK1 = 10_000
Q16_RANK2 = 1_000_000
Q16_NSTATS = 12


@dataclasses.dataclass(frozen=True)
class _Q16Stats(LinearAggregator):
    """A 12-column linear sum: each input row is a one-hot stat
    contribution, so the sum per (channel, day) assembles the whole stat
    row, with 0 for an absent rank (the left join with default 0 that
    the query's ``count(*) filter (...)`` columns imply)."""

    acc_dtypes = (I64,) * Q16_NSTATS
    out_dtypes = (I64,) * Q16_NSTATS
    name = "q16stats"

    def weigh(self, val_cols):
        return tuple(val_cols[:Q16_NSTATS])

    def finalize(self, acc_cols, count):
        return acc_cols


def q16(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Channel statistics per day, the whole stat set: (channel, day) ->
    (total_bids, rank1/2/3_bids, total_bidders, rank1/2/3_bidders,
    total_auctions, rank1/2/3_auctions), where the ranks split on price
    < 10,000, < 1,000,000 and the rest.

    Shape: one Count per bid rank (4 streams), one distinct + Count per
    (bidder x rank) and (auction x rank) (8 streams); each stat maps to a
    one-hot 12-column row, and one 12-column linear sum per (channel,
    day) assembles the output with 0 for empty ranks."""
    def rank_of(price):
        return torch.where(price < Q16_RANK1, 1,
                           torch.where(price < Q16_RANK2, 2, 3))

    base = bids.map_rows(
        lambda k, v: ((v[M.B_CHANNEL].to(I64), v[M.B_DATE] // DAY_MS),
                      (k[0], v[M.B_BIDDER], rank_of(v[M.B_PRICE]))),
        (I64, I64), (I64, I64, I64),
        name="q16-base")  # (channel, day) -> (auction, bidder, rank)

    def rank_filter(s, r, name):
        return s if r == 0 else s.filter_rows(
            lambda k, v, _r=r: v[2] == _r, name=name)

    stats = []  # (slot, stream of (channel, day) -> count)
    for r in range(4):  # bid counts: slots 0..3
        stats.append((r, rank_filter(base, r, f"q16-bids-r{r}")
                      .aggregate(Count(), name=f"q16-nbids-r{r}")))
    for col, what in ((1, "bidder"), (0, "auction")):
        for r in range(4):  # bidders: slots 4..7; auctions: slots 8..11
            slot = (4 if what == "bidder" else 8) + r
            uniq = rank_filter(base, r, f"q16-{what}-r{r}-f").map_rows(
                lambda k, v, _c=col: ((k[0], k[1], v[_c]), ()),
                (I64, I64, I64), (), name=f"q16-{what}-r{r}-key").distinct()
            cnt = uniq.index_by(
                lambda k, v: (k[0], k[1]), (I64, I64),
                val_fn=lambda k, v: (k[2],), val_dtypes=(I64,),
                name=f"q16-{what}-r{r}-by").aggregate(
                    Count(), name=f"q16-n{what}-r{r}")
            stats.append((slot, cnt))

    # one-hot each stat into the 12-column layout, and sum
    onehot = []
    for slot, s in stats:
        def mk(slot):
            def f(k, v):
                z = torch.zeros_like(v[0])
                return k, tuple(v[0] if i == slot else z
                                for i in range(Q16_NSTATS))
            return f

        onehot.append(s.map_rows(mk(slot), (I64, I64), (I64,) * Q16_NSTATS,
                                 name=f"q16-oh{slot}"))
    combined = onehot[0].sum_with(onehot[1:])
    combined.schema = ((I64, I64), (I64,) * Q16_NSTATS)
    return combined.aggregate(_Q16Stats(), name="q16-stats")


Q12_WINDOW_TICKS = 10


def q12(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Bid count per bidder per PROCESSING-time window. Processing time on
    a deterministic engine is the tick index: each step is one unit and a
    window spans 10 ticks. The tick counter is a stream_fold (no wall
    clock, so runs reproduce)."""
    from dbsp_tpu_torch.operators.basic import Apply2
    from dbsp_tpu_torch.zset.batch import Batch

    tick = bids.stream_fold(0, lambda acc, b: acc + 1)

    def attach(batch: Batch, t: int) -> Batch:
        win = (t - 1) // Q12_WINDOW_TICKS
        bidder = batch.vals[M.B_BIDDER]
        wcol = torch.full((batch.cap,), win, dtype=I64, device=batch.device)
        return Batch((bidder, wcol), (), batch.weights).consolidate()

    keyed = bids.circuit.add_binary_operator(
        Apply2(attach, "q12-procwin"), bids, tick)
    keyed.schema = ((I64, I64), ())
    return keyed.aggregate(Count(), name="q12-count")


def q13(persons: Stream, auctions: Stream, bids: Stream,
        side: Stream = None) -> Stream:
    """Bounded side-input join: bids enriched from a static keyed table,
    by default channel -> 1000 + channel."""
    from dbsp_tpu_torch.operators.basic import Generator
    from dbsp_tpu_torch.zset.batch import Batch

    c = bids.circuit
    if side is None:
        table = Batch.from_tuples([((ch, 1000 + ch), 1) for ch in range(16)],
                                  (I64,), (I64,), device=c.device)
        side = c.add_source(Generator(
            [table], default=Batch.empty((I64,), (I64,), device=c.device)))
        side.schema = ((I64,), (I64,))
    by_channel = bids.index_by(
        lambda k, v: (v[M.B_CHANNEL].to(I64),), (I64,),
        val_fn=lambda k, v: (k[0], v[M.B_BIDDER], v[M.B_PRICE], v[M.B_DATE]),
        val_dtypes=(I64, I64, I64, I64), name="q13-by-channel")
    return by_channel.join_index(
        side, lambda k, bv, sv: ((bv[0],), (bv[1], bv[2], bv[3], sv[0])),
        (I64,), (I64, I64, I64, I64), name="q13-join")


def q14(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Calculation + filter: euro price > 1M, with the bid's time of day
    bucketed. Output key (auction), vals (bidder, eur, timetype, ts);
    timetype 0 = day [8, 18), 1 = night [0, 6) | [20, 24), 2 = other."""
    def conv(k, v):
        eur = v[M.B_PRICE] * 908 // 1000
        hour = (v[M.B_DATE] // 3_600_000) % 24
        night = ((hour < 6) | (hour >= 20)).to(I64)
        day = ((hour >= 8) & (hour < 18)).to(I64)
        timetype = torch.where(day == 1, 0, torch.where(night == 1, 1, 2))
        return k, (v[M.B_BIDDER], eur, timetype, v[M.B_DATE])

    mapped = bids.map_rows(conv, M.BID_KEY, (I64, I64, I64, I64),
                           name="q14-calc")
    return mapped.filter_rows(lambda k, v: v[1] > 1_000_000,
                              name="q14-filter")


def q17(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Auction bid statistics per day: (auction, day) -> (count, min, max,
    avg price)."""
    keyed = bids.map_rows(
        lambda k, v: ((k[0], v[M.B_DATE] // DAY_MS), (v[M.B_PRICE],)),
        (I64, I64), (I64,), name="q17-key", preserves_first_key=True)
    cnt = keyed.aggregate(Count(), name="q17-count")
    mn = keyed.aggregate(Min(0), name="q17-min")
    mx = keyed.aggregate(Max(0), name="q17-max")
    avg = keyed.aggregate(Average(0), name="q17-avg")
    j1 = cnt.join_index(mn, lambda k, a, b: (k, (a[0], b[0])),
                        (I64, I64), (I64, I64), name="q17-j1",
                        preserves_first_key=True)
    j2 = j1.join_index(mx, lambda k, a, b: (k, (a[0], a[1], b[0])),
                       (I64, I64), (I64, I64, I64), name="q17-j2",
                       preserves_first_key=True)
    return j2.join_index(avg, lambda k, a, b: (k, (a[0], a[1], a[2], b[0])),
                         (I64, I64), (I64, I64, I64, I64), name="q17-j3",
                         preserves_first_key=True)


def q18(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Last bid of each bidder: (bidder, ts, auction, price)."""
    by_bidder = bids.index_by(
        lambda k, v: (v[M.B_BIDDER],), (I64,),
        val_fn=lambda k, v: (v[M.B_DATE], k[0], v[M.B_PRICE]),
        val_dtypes=(I64, I64, I64), name="q18-by-bidder")
    return by_bidder.topk(1, largest=True, name="q18-last")


def q19(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Top 10 bids by price per auction (the window-function query),
    ranked on (price, ts, bidder) lexicographically."""
    ranked = bids.index_by(
        lambda k, v: (k[0],), M.BID_KEY,
        val_fn=lambda k, v: (v[M.B_PRICE], v[M.B_DATE], v[M.B_BIDDER]),
        val_dtypes=(I64, I64, I64), name="q19-rank",
        preserves_first_key=True)
    return ranked.topk(10, largest=True, name="q19-top10")


def q20(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Bids expanded with their auction's info, category 10 only:
    (auction) -> (bidder, price, item, seller)."""
    cat = auctions.filter_rows(lambda k, v: v[M.A_CATEGORY] == Q3_CATEGORY,
                               name="q20-cat")
    by_id = cat.index_by(
        lambda k, v: (k[0],), M.AUCTION_KEY,
        val_fn=lambda k, v: (v[M.A_ITEM].to(I64), v[M.A_SELLER]),
        val_dtypes=(I64, I64), name="q20-auctions", preserves_first_key=True)
    return bids.join_index(
        by_id, lambda k, bv, av: (k, (bv[M.B_BIDDER], bv[M.B_PRICE],
                                      av[0], av[1])),
        (I64,), (I64, I64, I64, I64), name="q20-join",
        preserves_first_key=True)


def q21(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """Channel id classification: channels 0-3 map to fixed ids (the
    apple / google / facebook / baidu CASE), others take the channel_id of
    their URL. Channels are dictionary codes; ``nexmark/strings.py`` holds
    the strings, built so this arithmetic EQUALS the CASE and the regex
    over the decoded strings."""
    def classify(k, v):
        ch = v[M.B_CHANNEL].to(I64)
        chan_id = torch.where(ch < 4, ch, 100 + ch)
        return k, (v[M.B_BIDDER], v[M.B_PRICE], ch, chan_id)

    return bids.map_rows(classify, M.BID_KEY, (I64, I64, I64, I64),
                         name="q21")


def q22(persons: Stream, auctions: Stream, bids: Stream) -> Stream:
    """URL split: dir1 / dir2 / dir3 of the bid URL. URLs are dictionary
    codes; ``nexmark/strings.py`` holds the strings, built so this mod /
    div arithmetic EQUALS split_part over the decoded URL."""
    def split(k, v):
        url = v[M.B_CHANNEL].to(I64)  # the channel doubles as the URL code
        dir1 = url % 7
        dir2 = (url // 7) % 11
        dir3 = (url // 77) % 13
        return k, (v[M.B_BIDDER], v[M.B_PRICE], dir1, dir2, dir3)

    return bids.map_rows(split, M.BID_KEY, (I64, I64, I64, I64, I64),
                         name="q22")
