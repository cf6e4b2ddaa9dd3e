"""Roofline accounting over a recorded trace of aten ops (the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``, which reads
optimized HLO text).

The port runs eagerly, so there is no HLO: :class:`OpTrace`, a
``TorchDispatchMode``, records every aten op a step dispatches (below
DTensor: each rank's local program), with its operands' and results' shapes
and dtypes and a scope tag.  :func:`analyze` derives the three roofline
inputs from that trace, under the JAX package's names:

  * flops            -- 2*M*N*K for every mm / bmm / addmm / baddbmm
                        (``torch.utils.flop_counter``'s formulas), + 1 flop
                        per result element for the aten counterparts of the
                        JAX package's arithmetic elementwise set;
  * hbm_bytes        -- operands + result of every op that is not a view:
                        in eager mode each op is a fusion boundary;
                        ``attention_hbm_bytes`` is the part recorded inside
                        ``layers.chunked_attention`` (its forward, its
                        recompute and its backward);
  * collective_bytes -- the ``_c10d_functional`` collectives, by kind, under
                        the JAX package's wire model: an all-reduce moves 2x
                        its operand, an all-gather its gathered result, a
                        reduce-scatter or all-to-all its operand.

Eager mode unrolls every loop, so there are no trip counts to resolve;
``n_warnings`` counts the ops with floating-point work that the model does
not count (reductions, activations, sorts, scatters).
"""
from __future__ import annotations

import sys
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# aten counterparts of the JAX package's _ELEMENTWISE set (1 flop / element)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp",
    "log", "tanh", "rsqrt", "sqrt", "neg", "abs", "sigmoid", "cos", "sin",
    "floor", "ceil", "round", "expm1", "log1p", "where", "eq", "ne", "lt",
    "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "clamp", "clamp_min", "clamp_max", "square",
}
_MATMULS = ("mm", "bmm", "addmm", "baddbmm")
# the port's kernels in their shape-only (meta) form: flops per result
# element (a multiply-add a step)
_KERNELS = {"rg_lru_scan": 2, "rg_lru_scan_bwd": 1}
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops that move or make data but do no arithmetic
_DATA = {
    "copy", "_to_copy", "clone", "empty", "empty_like", "empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "fill", "arange", "cat", "stack", "index_select", "gather", "embedding",
    "repeat_interleave", "index", "constant_pad_nd", "contiguous",
    "scalar_tensor",
    "lift_fresh", "_local_scalar_dense", "new_empty", "new_zeros",
    "new_full", "new_empty_strided", "masked_fill", "index_copy",
    "slice_scatter", "select_scatter", "one_hot", "split_with_sizes_copy",
}
# ops that move nothing: a collective's completion
_FREE = {"wait_tensor"}
_SCOPE_FN = "chunked_attention"
ATTENTION = "attention"


def _name(func) -> str:
    """``aten::mm`` -> ``mm``; ``_c10d_functional::all_reduce`` ->
    ``all_reduce``; in-place ``add_`` -> ``add``."""
    base = func._schema.name.split("::")[-1]
    return base[:-1] if base.endswith("_") and not base.startswith("_") \
        else base


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _meta(x) -> Optional[List]:
    if isinstance(x, torch.Tensor):
        return [list(x.shape), str(x.dtype).replace("torch.", "")]
    return None


def _flat(xs) -> List:
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out.extend(_flat(x))
        else:
            out.append(x)
    return out


def _in_scope() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == _SCOPE_FN:
            return True
        f = f.f_back
    return False


class OpTrace(TorchDispatchMode):
    """Records each aten op dispatched while it is active:
    ``{"op", "view", "in", "out", "scope"}`` with shapes and dtypes; and
    the live bytes of the tensors the ops create (``peak_bytes``: the most
    alive at once, on top of whatever existed before).

    Backward ops take the scope their forward op had: each op's scope is
    noted on the autograd node that records it (``torch.autograd.graph``
    metadata) and read back while the node runs."""

    def __init__(self):
        super().__init__()
        self.ops: List[Dict[str, Any]] = []
        self.live = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()

    def _free(self, n: int) -> None:
        with self._lock:
            self.live -= n

    def _scope(self) -> str:
        if _in_scope():  # the forward, or remat's recompute of it
            return ATTENTION
        node = torch._C._current_autograd_node()
        return "" if node is None else node.metadata.get("scope", "")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            # let DTensor desugar the op into local ops and collectives,
            # which come back through this mode
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_args = _flat(list(args) + list(kwargs.values()))
        if any(isinstance(a, FakeTensor) for a in flat_args):
            # DTensor's sharding propagation works out a result's global
            # shape on fake tensors: no rank runs that op
            return out
        outs = _flat(out if isinstance(out, (list, tuple)) else [out])
        view = _is_view(func)
        self.ops.append({
            "op": _name(func), "view": view,
            "in": [m for m in (_meta(a) for a in flat_args) if m is not None],
            "out": [m for m in (_meta(o) for o in outs) if m is not None],
            "scope": self._scope(),
        })
        if not view:
            for o in outs:
                if isinstance(o, torch.Tensor) and o._base is None:
                    n = o.numel() * o.element_size()
                    with self._lock:
                        self.live += n
                        self.peak_bytes = max(self.peak_bytes, self.live)
                    weakref.finalize(o, self._free, n)
        return out


class ScopeTags(torch.overrides.TorchFunctionMode):
    """Notes ``attention`` on the autograd nodes created inside
    ``layers.chunked_attention``, for :class:`OpTrace` to read in the
    backward."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            tag = None
            for o in _flat(out if isinstance(out, (list, tuple)) else [out]):
                fn = getattr(o, "grad_fn", None)
                if fn is not None:
                    if tag is None:
                        tag = ATTENTION if _in_scope() else ""
                    if tag:
                        fn.metadata["scope"] = tag
        return out


def _elems(meta) -> int:
    n = 1
    for d in meta[0]:
        n *= int(d)
    return n


_BYTES = {"bool": 1, "uint8": 1, "int8": 1, "float8_e4m3fn": 1,
          "float8_e5m2": 1, "int16": 2, "bfloat16": 2, "float16": 2,
          "int32": 4, "float32": 4, "int64": 8, "float64": 8,
          "complex64": 8, "complex128": 16}


def _bytes(meta) -> int:
    return _elems(meta) * _BYTES.get(meta[1], 4)


def _is_float(meta) -> bool:
    return meta[1].startswith(("float", "bfloat", "complex"))


def _matmul_flops(op: str, ins: List) -> float:
    from torch.utils import flop_counter as fc
    shapes = [m[0] for m in ins]
    if op == "mm":
        return float(fc.mm_flop(shapes[0], shapes[1]))
    if op == "bmm":
        return float(fc.bmm_flop(shapes[0], shapes[1]))
    if op == "addmm":
        return float(fc.addmm_flop(shapes[0], shapes[1], shapes[2]))
    return float(fc.baddbmm_flop(shapes[0], shapes[1], shapes[2]))


def analyze(trace: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Roofline inputs of a trace (the JAX package's ``analyze`` keys)."""
    flops = hbm = attn = coll = 0.0
    per: Dict[str, float] = {}
    warnings: List[str] = []
    for rec in trace:
        op, ins, outs = rec["op"], rec["in"], rec["out"]
        if rec["view"] or op in _FREE:
            continue
        kind = _COLLECTIVES.get(op)
        if kind is not None:
            b = sum(_bytes(m) for m in ins) or sum(_bytes(m) for m in outs)
            if kind == "all-reduce":
                wire = 2.0 * b
            elif kind == "all-gather":
                wire = max(b, sum(_bytes(m) for m in outs))
            else:
                wire = b
            coll += wire
            per[kind] = per.get(kind, 0.0) + wire
            hbm += b
            continue
        b = sum(_bytes(m) for m in ins) + sum(_bytes(m) for m in outs)
        hbm += b
        if rec["scope"] == ATTENTION:
            attn += b
        if op in _MATMULS:
            flops += _matmul_flops(op, ins)
        elif op in _ELEMENTWISE:
            flops += sum(_elems(m) for m in outs)
        elif op in _KERNELS:
            flops += _KERNELS[op] * sum(_elems(m) for m in outs)
        elif op not in _DATA and any(_is_float(m) for m in outs):
            warnings.append(f"uncounted float op {op}")
    return {
        "flops": flops,
        "hbm_bytes": hbm,
        "attention_hbm_bytes": attn,
        "collective_bytes": coll,
        "per_collective": {k: int(v) for k, v in per.items()},
        "warnings": sorted(set(warnings))[:20],
        "n_warnings": len(warnings),
    }
