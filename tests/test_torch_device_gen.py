"""The port's device-side Nexmark generator
(dbsp_tpu_torch/nexmark/device_gen.py) against the reference's
device_gen.generate_tick and against the port's numpy generator, column
for column, exactly (the pattern of tests/test_compiled.py's
test_device_generator_bit_identical). On the CPU it runs the same tensor
arithmetic the card runs."""

import numpy as np
import pytest
import torch

from dbsp_tpu.nexmark import GeneratorConfig, device_gen
from dbsp_tpu_torch.nexmark import GeneratorConfig as TGeneratorConfig
from dbsp_tpu_torch.nexmark import NexmarkGenerator as TNexmarkGenerator
from dbsp_tpu_torch.nexmark import device_gen as tdevice_gen
from dbsp_tpu_torch.nexmark import generator as tgenerator

CFG = GeneratorConfig(seed=1)
TCFG = TGeneratorConfig(seed=1)
EPT = 8


def _same_batch(got, want, what):
    assert got.runs == tuple(want.runs) if want.runs is not None \
        else got.runs is None, what
    for i, (g, w) in enumerate(zip((*got.cols, got.weights),
                                   (*want.cols, want.weights))):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} column {i}")


@pytest.mark.parametrize("e0,epochs", [(0, 64), (3 * EPT, EPT), (977, 5)])
def test_generate_tick_equals_reference(e0, epochs):
    want = device_gen.generate_tick(CFG, e0, epochs)
    got = tdevice_gen.generate_tick(TCFG, e0, epochs, device="cpu")
    for g, w, rel in zip(got, want, ("persons", "auctions", "bids")):
        _same_batch(g, w, rel)
    # a device scalar e0 (the compiled handle's tick cursor) gives the same
    got_t = tdevice_gen.generate_tick(TCFG, torch.tensor(e0), epochs)
    for g, w, rel in zip(got_t, want, ("persons", "auctions", "bids")):
        _same_batch(g, w, rel)


def test_generate_tick_equals_numpy_generator():
    """Every column equals the numpy generator's, the log-uniform price
    included (through the shared table), and a tick generated alone
    equals its slice of the event stream (batch invariance)."""
    g = TNexmarkGenerator(TCFG)
    host = g.generate(0, 50 * 64)
    p, a, b = tdevice_gen.generate_tick(TCFG, 0, 64, device="cpu")
    hp, ha, hb = host["persons"], host["auctions"], host["bids"]
    np.testing.assert_array_equal(p.keys[0].numpy(), hp["id"])
    for i, c in enumerate(["name", "city", "state", "email", "date_time"]):
        np.testing.assert_array_equal(p.vals[i].numpy(), hp[c], err_msg=c)
    np.testing.assert_array_equal(a.keys[0].numpy(), ha["id"])
    for i, c in enumerate(["item", "seller", "category", "initial_bid",
                           "reserve", "date_time", "expires"]):
        np.testing.assert_array_equal(a.vals[i].numpy(), ha[c], err_msg=c)
    want = {}
    for i in range(len(hb["auction"])):
        row = (int(hb["auction"][i]), int(hb["bidder"][i]),
               int(hb["price"][i]), int(hb["channel"][i]),
               int(hb["date_time"][i]))
        want[row] = want.get(row, 0) + 1
    assert b.to_dict() == want
    # batch invariance: tick 3 alone == events [1200, 1600)
    p3, a3, _ = tdevice_gen.generate_tick(TCFG, 3 * EPT, EPT, device="cpu")
    host3 = g.generate(3 * EPT * 50, 4 * EPT * 50)
    np.testing.assert_array_equal(p3.keys[0].numpy(),
                                  host3["persons"]["id"])
    np.testing.assert_array_equal(a3.vals[1].numpy(),
                                  host3["auctions"]["seller"])


def test_mix64_on_int64_equals_uint64():
    """splitmix64 with wrapping int64 products and masked logical shifts
    equals the uint64 finalizer bit for bit, sign-bit inputs included."""
    x = np.array([0, 1, 2**31, 2**62 + 12345, 2**63 - 1, -1, -(2**63),
                  -987654321], np.int64)
    for seed in (0, 1, 2**40 + 7):
        want = tgenerator._mix64(seed, x.view(np.uint64)).view(np.int64)
        got = tdevice_gen._mix64(seed, torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
        # the 31-bit draws of the generator
        np.testing.assert_array_equal(
            tdevice_gen._shr(got, 33).numpy(),
            (want.view(np.uint64) >> np.uint64(33)).astype(np.int64))


def test_generate_tick_runs_on_the_card_by_default():
    """Without a device (and an int e0) it asks for the card: with no CUDA
    it raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        p, _, _ = tdevice_gen.generate_tick(TCFG, 0, 2)
        assert p.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdevice_gen.generate_tick(TCFG, 0, 2)
