"""The runner's `debug_nans` (counterpart of `jax.debug_nans(True)` around
the JAX runner's run).

`DebugNans` is a TorchDispatchMode: while it is active in a thread,
every dispatched operation whose floating output holds a NaN raises
FloatingPointError naming the operation. The hand-written kernels are
ctypes launches, not dispatched operations, so their wrappers hand their
outputs to `check_kernel_outputs`, which checks them while the mode is
active.

Two kinds of operation are not checked. Those that return uninitialized
memory (`empty` and its kin): their contents are not values yet. And
those that write a constant (`full`, `fill_`, a literal lifted into a
tensor): a NaN there is a sentinel the code chose, which a `torch.where`
then keeps or drops, as the JAX package's `jnp.where(ok, x, jnp.nan)`
does inside the jit of `jnp.where` itself, where `jax.debug_nans` does not
look; the NaN that such a select lets through is caught in its output.
The JAX runner computes its per-pair metrics eagerly, so everything else
the port dispatches has a counterpart that `jax.debug_nans` checks.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_UNCHECKED = frozenset({
    # uninitialized memory
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default,
    # constants
    _aten.full.default, _aten.full_like.default, _aten.new_full.default,
    _aten.fill_.Scalar, _aten.fill.Scalar, _aten.scalar_tensor.default,
    _aten.lift_fresh.default, _aten.lift_fresh_copy.default})


def _raise_on_nan(what: str, outputs):
    for x in tree_leaves(outputs):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and bool(torch.isnan(x).any())):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {what}")


class DebugNans(TorchDispatchMode):
    """Raise FloatingPointError at the first operation that returns a
    NaN (`with DebugNans(): ...`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _UNCHECKED:
            _raise_on_nan(str(func), out)
        return out


def check_kernel_outputs(name: str, *outputs):
    """Under an active `DebugNans`, raise FloatingPointError where a
    kernel's output holds a NaN; otherwise do nothing."""
    if any(isinstance(m, DebugNans)
           for m in _get_current_dispatch_mode_stack()):
        _raise_on_nan(f"kernel {name}", outputs)
