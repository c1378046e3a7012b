"""Device-side Nexmark event generation: the input of the compiled engine.
Counterpart of ``dbsp_tpu/nexmark/device_gen.py``.

The host generator (:mod:`dbsp_tpu_torch.nexmark.generator`) is
counter-based: every column of event ``i`` is a pure function of
``(seed, i)`` through the splitmix64 finalizer. The same arithmetic runs
here as tensor ops on the card, so a tick of the compiled engine needs no
host work and no host-to-device copy for its input: ``e0`` may itself be
a device scalar (the compiled handle's tick cursor).

splitmix64 is uint64 arithmetic, and torch's ``uint64`` lacks the
operations it needs. It runs on int64 instead: additions and products
wrap modulo 2^64 in two's complement exactly as they do unsigned, and
every right shift is made LOGICAL by masking off the bits an arithmetic
shift copies from the sign. The one transcendental (the log-uniform bid
price) is the exact 65,536-entry :func:`price_table`, computed once with
numpy as the host generator computes it, so card and host agree bit for
bit. ``tests/test_torch_device_gen.py`` holds every column to the
reference's device generator and to the port's numpy generator.

Static shapes: a tick of ``epochs`` epochs (50 events each) holds exactly
``epochs`` persons, ``3 * epochs`` auctions and ``46 * epochs`` bids.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dbsp_tpu_torch.nexmark import model as M
from dbsp_tpu_torch.nexmark.generator import GeneratorConfig
from dbsp_tpu_torch.zset.batch import WEIGHT_DTYPE, Batch

_U64 = 1 << 64


def _s64(x: int) -> int:
    """The int64 with the same 64 bits as the unsigned ``x``."""
    x %= _U64
    return x - _U64 if x >= 1 << 63 else x


_MUL1 = _s64(0xBF58476D1CE4E5B9)
_MUL2 = _s64(0x94D049BB133111EB)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits: the arithmetic shift, then the
    copied sign bits masked off."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix64(seed: int, x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 counters, bit for bit the uint64
    one of the host generator (result as the int64 of the same bits)."""
    z = x.to(torch.int64) + _s64(seed * 0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _MUL1
    z = (z ^ _shr(z, 27)) * _MUL2
    return z ^ _shr(z, 31)


def price_table() -> np.ndarray:
    """All 65,536 possible bid prices, exactly as the host generator
    computes them (log-uniform in [1, 10^7))."""
    r = np.arange(65536, dtype=np.float64)
    p = np.exp(np.log(10_000_000) * (r / 65536.0))
    return np.maximum(p.astype(np.int64), 1)


_PRICES: Dict[torch.device, torch.Tensor] = {}


def _prices(device: torch.device) -> torch.Tensor:
    """The price table on ``device``, uploaded once per device."""
    t = _PRICES.get(device)
    if t is None:
        t = _PRICES[device] = torch.from_numpy(price_table()).to(device)
    return t


def _draws(seed: int, n: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The five 31-bit draws for each absolute event index."""
    return tuple(_shr(_mix64(seed, n * 8 + j), 33) for j in range(5))


def _timestamps(cfg: GeneratorConfig, n: torch.Tensor) -> torch.Tensor:
    step_ns = 1_000_000_000 // cfg.first_event_rate
    return cfg.base_time_ms + torch.div(n * step_ns, 1_000_000,
                                        rounding_mode="floor")


def _resolve(e0, device) -> torch.device:
    if isinstance(e0, torch.Tensor):
        return e0.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "generate on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _per_epoch(ep: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each epoch repeated ``k`` times, and the offset 0..k-1 within it
    (a view and an arange, so no size has to be read back)."""
    epochs = ep.shape[0]
    rep = ep[:, None].expand(epochs, k).reshape(-1)
    off = torch.arange(k, dtype=torch.int64, device=ep.device).repeat(epochs)
    return rep, off


def generate_tick(cfg: GeneratorConfig, e0, epochs: int, device=None
                  ) -> Tuple[Batch, Batch, Batch]:
    """Batches for epochs [e0, e0 + epochs), i.e. events [50 * e0,
    50 * (e0 + epochs)): consolidated (persons, auctions, bids) at their
    natural capacities (epochs, 3 * epochs, 46 * epochs).

    ``e0`` is an int or a 0-d int64 tensor; a tensor fixes the device.
    Otherwise ``device=None`` means the card, and raises without CUDA."""
    dev = _resolve(e0, device)
    ep = e0 + torch.arange(epochs, dtype=torch.int64, device=dev)

    # -- persons: event n = 50 * ep ------------------------------------------
    n_p = ep * M.PROPORTION_DENOMINATOR
    r = _draws(cfg.seed, n_p)
    persons = Batch(
        keys=(M.FIRST_PERSON_ID + ep,),
        vals=((r[0] % cfg.num_name_codes).to(torch.int32),
              (r[1] % cfg.num_city_codes).to(torch.int32),
              (r[2] % cfg.num_state_codes).to(torch.int32),
              (r[3] % cfg.num_name_codes).to(torch.int32),
              _timestamps(cfg, n_p)),
        weights=torch.ones((epochs,), dtype=WEIGHT_DTYPE, device=dev),
        runs=(epochs,))

    # -- auctions: events n = 50 * ep + 1 + i, i in 0..3 ---------------------
    epa, off = _per_epoch(ep, M.AUCTION_PROPORTION)
    n_a = epa * M.PROPORTION_DENOMINATOR + M.PERSON_PROPORTION + off
    ts = _timestamps(cfg, n_a)
    r = _draws(cfg.seed, n_a)
    aid = M.FIRST_AUCTION_ID + epa * M.AUCTION_PROPORTION + off
    max_person = torch.clamp(epa, min=0)
    hot = (r[0] % 1000) < int(cfg.hot_bidder_ratio * 1000)
    recent = torch.clamp(max_person - cfg.hot_window, min=0)
    seller_idx = torch.where(
        hot, recent + r[1] % torch.clamp(max_person - recent + 1, min=1),
        r[1] % torch.clamp(max_person + 1, min=1))
    price0 = 1 + (r[2] % 10_000)
    span = cfg.auction_expire_max_ms - cfg.auction_expire_min_ms
    auctions = Batch(
        keys=(aid,),
        vals=((r[3] % cfg.num_name_codes).to(torch.int32),
              M.FIRST_PERSON_ID + seller_idx,
              M.FIRST_CATEGORY_ID + r[4] % M.NUM_CATEGORIES,
              price0,
              price0 + (r[2] >> 16) % 10_000,
              ts,
              ts + cfg.auction_expire_min_ms + r[0] % span),
        weights=torch.ones((epochs * M.AUCTION_PROPORTION,),
                           dtype=WEIGHT_DTYPE, device=dev),
        runs=(epochs * M.AUCTION_PROPORTION,))

    # -- bids: events n = 50 * ep + 4 + i, i in 0..46 ------------------------
    epb, offb = _per_epoch(ep, M.BID_PROPORTION)
    n_b = (epb * M.PROPORTION_DENOMINATOR + M.PERSON_PROPORTION +
           M.AUCTION_PROPORTION + offb)
    ts = _timestamps(cfg, n_b)
    r = _draws(cfg.seed, n_b)
    max_auction = torch.clamp((epb + 1) * M.AUCTION_PROPORTION - 1, min=0)
    max_person = epb
    hot_a = (r[0] % 1000) < int(cfg.hot_auction_ratio * 1000)
    recent_a = torch.clamp(max_auction - cfg.hot_window, min=0)
    auction_idx = torch.where(
        hot_a, recent_a + r[1] % torch.clamp(max_auction - recent_a + 1,
                                             min=1),
        r[1] % torch.clamp(max_auction + 1, min=1))
    hot_b = (r[2] % 1000) < int(cfg.hot_bidder_ratio * 1000)
    recent_b = torch.clamp(max_person - cfg.hot_window, min=0)
    bidder_idx = torch.where(
        hot_b, recent_b + r[3] % torch.clamp(max_person - recent_b + 1,
                                             min=1),
        r[3] % torch.clamp(max_person + 1, min=1))
    prices = _prices(dev)[r[4] % 65536]
    bids = Batch(
        keys=(M.FIRST_AUCTION_ID + auction_idx,),
        vals=(M.FIRST_PERSON_ID + bidder_idx,
              prices,
              (r[0] % cfg.num_channels).to(torch.int32),
              ts),
        weights=torch.ones((epochs * M.BID_PROPORTION,), dtype=WEIGHT_DTYPE,
                           device=dev))

    # persons and auctions arrive sorted by their dense ids (consolidated);
    # bids are keyed by a random auction id and need the one sort
    return persons, auctions, bids.consolidate()
