"""Incremental equi-join in the bilinear delta form. Counterpart of
``dbsp_tpu/operators/join.py``:

    Δ(A ⋈ B)_t = ΔA_t ⋈ T(B)_t  +  ΔB_t ⋈ T(A)_{t-1}

where T(X)_t is the integral of X up to and including tick t. Each term is
one launch of the ladder join over the traced side's spine levels
(``cursor.join_ladder``), with a grow-on-demand output capacity, and the
two raw outputs are consolidated once.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from dbsp_tpu_torch.circuit.builder import CircuitError, Stream
from dbsp_tpu_torch.circuit.operator import BinaryOperator
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.zset import cursor
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap, concat_batches

# fn(key_cols, left_val_cols, right_val_cols) -> (out_key_cols, out_val_cols)
JoinFn = Callable[[Tuple, Tuple, Tuple], Tuple[Tuple, Tuple]]


class JoinCore:
    """Grow-on-demand driver joining deltas against spine levels: ONE
    ladder launch for all levels into one buffer with one monotone output
    capacity, and one device-to-host read of the match total per eval."""

    def __init__(self, nk: int, fn: JoinFn):
        self.nk = nk
        self.fn = fn
        self.out_cap = 0

    def join_levels(self, delta: Batch, levels: Sequence[Batch]
                    ) -> List[Batch]:
        """The RAW joined output as a 0- or 1-element list."""
        if not levels:
            return []
        if not self.out_cap:
            self.out_cap = bucket_cap(max(64, delta.cap))
        out, total = cursor.join_ladder(delta, levels, self.nk, self.fn,
                                        self.out_cap)
        t = int(total)
        if t > self.out_cap:  # overflow: grow and relaunch
            self.out_cap = bucket_cap(t)
            out, _ = cursor.join_ladder(delta, levels, self.nk, self.fn,
                                        self.out_cap)
        return [out]


class JoinOp(BinaryOperator):
    """Consumes the two trace streams; emits the output delta Z-set."""

    def __init__(self, fn: JoinFn, nk: int, out_schema, device, name="join"):
        self.name = name
        self.out_schema = out_schema
        self.device = device
        # the left delta joins the right trace INCLUDING this tick's right
        # delta; the right delta joins the left trace EXCLUDING this tick's
        self._left_core = JoinCore(nk, fn)
        self._right_core = JoinCore(nk, lambda k, rv, lv: fn(k, lv, rv))

    def eval(self, left: TraceView, right: TraceView) -> Batch:
        outs = self._left_core.join_levels(left.delta, right.spine.batches)
        outs += self._right_core.join_levels(right.delta, left.pre_levels)
        if not outs:
            return Batch.empty(*self.out_schema, device=self.device)
        out = outs[0] if len(outs) == 1 else concat_batches(outs)
        return out.consolidate().shrink_to_fit()


@stream_method
def join_index(self: Stream, other: Stream, fn: JoinFn, out_key_dtypes,
               out_val_dtypes, name: str = "join",
               preserves_first_key: bool = False) -> Stream:
    """Incremental equi-join on the streams' key columns;
    ``fn(key_cols, left_val_cols, right_val_cols)`` maps each matching
    pair to output key and value columns. ``preserves_first_key`` asserts
    that ``fn`` emits the join key's first column first: the reference
    keeps the output's worker placement by it; with one worker it changes
    nothing."""
    ls = require_schema(self, "join (left input)")
    rs = require_schema(other, "join (right input)")
    if ls[0] != rs[0]:
        raise CircuitError(f"join key dtypes differ: {ls[0]} vs {rs[0]} — "
                           "cast one side so both share the key dtypes")
    out_schema = (tuple(out_key_dtypes), tuple(out_val_dtypes))
    out = self.circuit.add_binary_operator(
        JoinOp(fn, len(ls[0]), out_schema, self.circuit.device, name),
        self.trace(), other.trace())
    out.schema = out_schema
    return out
