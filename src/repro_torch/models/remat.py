"""Rematerialisation of a layer's activations (the port of the reference's
``jax.checkpoint`` over its layer scan, pattern group and encoder layer,
with ``remat_policy`` naming an entry of ``jax.checkpoint_policies``).

Every training gradient of the port goes through ``torch.func``
(``grad_and_value``, under ``vmap`` on the simulated worker axis), and
``torch.utils.checkpoint`` runs under neither: its non-reentrant form
rests on saved-tensor hooks, which ``torch.func.grad`` refuses, and its
reentrant form is an ``autograd.Function`` without ``setup_context``.
``checkpoint`` is therefore an ``autograd.Function`` of its own, with
``setup_context`` and a generated vmap rule: its forward runs the body and
keeps nothing of it but the body's inputs (the residual stream and the
layer's parameters); its backward runs the body again under
``torch.func.vjp`` and pulls the output gradients through.  The recompute
repeats the same eager ops on the same inputs, so loss and gradients are
those of the body run once, bit for bit.  It is the phase
``grads/recompute`` (``obs/spans.py``), so that a traced step tells the
recompute's device time from the backward's.

Policies (``POLICIES``): ``None`` and ``"nothing_saveable"`` save nothing
(full remat); ``"everything_saveable"`` saves everything, which is no remat
at all; the dots policies keep the outputs of the matrix products, which
the recompute then takes instead of computing them again.  A recording
dispatch mode in the forward keeps each product's output in order, and a
replaying one in the backward hands them back: ``aten.mm``, ``addmm``,
``bmm`` and ``baddbmm`` for ``dots_saveable`` and ``checkpoint_dots``,
without the batched two (products with a batch dimension) for the
``*_no_batch_dims`` pair.  Any other name, the factory policies such as
``save_only_these_names`` among them, raises ``ValueError``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, FrozenSet, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.obs import spans

_aten = torch.ops.aten
_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}
_NOTHING: FrozenSet = frozenset()

# remat_policy -> the aten products whose outputs are kept (None: no remat)
POLICIES = {
    None: _NOTHING,
    "nothing_saveable": _NOTHING,
    "everything_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH,
}


def saved_products(policy: Optional[str]) -> Optional[FrozenSet]:
    """The products whose outputs ``policy`` keeps (empty: full remat), or
    None for no remat.  Raises ``ValueError`` for a name without a
    counterpart here."""
    if policy not in POLICIES:
        names = ", ".join(repr(k) for k in POLICIES)
        raise ValueError(f"remat_policy={policy!r} has no counterpart in the "
                         f"port; supported: {names}")
    return POLICIES[policy]


class _Kept:
    """The products' outputs of one forward, in call order.  A plain object
    (not a list) so that ``torch.func`` passes it through unflattened."""

    def __init__(self):
        self.outputs: List[torch.Tensor] = []


class _Record(TorchDispatchMode):
    def __init__(self, ops: FrozenSet, kept: _Kept):
        super().__init__()
        self.ops, self.kept = ops, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.kept.outputs.append(out)
        return out


class _Replay(TorchDispatchMode):
    def __init__(self, ops: FrozenSet, kept: _Kept):
        super().__init__()
        self.ops, self.kept, self.used = ops, kept, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if self.used >= len(self.kept.outputs):
            raise RuntimeError(f"remat: the recompute calls {func} more "
                               f"often than the forward did")
        out = self.kept.outputs[self.used]
        self.used += 1
        return out


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(body, ops, kept, *args):
        if not ops:
            return body(*args)
        with _Record(ops, kept):
            return body(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        body, ops, kept, *args = inputs
        ctx.body, ctx.ops, ctx.kept = body, ops, kept
        ctx.save_for_backward(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        # differentiate by the floating inputs; the others (positions)
        # stay as they were
        wrt = [i for i, a in enumerate(args) if a.is_floating_point()]

        def body(*ts):
            full = list(args)
            for i, t in zip(wrt, ts):
                full[i] = t
            return ctx.body(*full)

        primals = [args[i] for i in wrt]
        replay = _Replay(ctx.ops, ctx.kept) if ctx.ops else None
        pulled = _recompute(body, primals, grads,
                            replay or contextlib.nullcontext())
        if replay is not None and replay.used != len(ctx.kept.outputs):
            raise RuntimeError(
                f"remat: the recompute took {replay.used} of the "
                f"forward's {len(ctx.kept.outputs)} products")
        out = [None] * len(args)
        for i, g in zip(wrt, pulled):
            out[i] = g
        return (None, None, None) + tuple(out)


def _recompute(body: Callable, primals, grads, replay) -> List[torch.Tensor]:
    """The body run again (under ``replay``) and its output gradients
    pulled back to ``primals``: through ``torch.func.vjp`` inside a
    ``torch.func`` transform, else with plain autograd (a DTensor mesh's
    gradient, whose redistributions are autograd Functions that
    ``torch.func`` refuses)."""
    if torch._C._are_functorch_transforms_active():
        with spans.phase("grads/recompute"), replay:
            _, pull = torch.func.vjp(body, *primals)
        # torch.func.grad runs the backward with create_graph=True: the
        # graph of the pull would keep this layer's recompute alive until
        # the whole backward ends.  The gradients are not differentiated
        # again, so they leave detached and the graph dies here.
        return [g.detach() for g in pull(grads)]
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in primals]
        with spans.phase("grads/recompute"), replay:
            outs = body(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        pulled = torch.autograd.grad([o for o, _ in pairs], leaves,
                                     [g for _, g in pairs],
                                     allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, pulled)]


def checkpoint(body: Callable, ops: FrozenSet, *args: torch.Tensor):
    """``body(*args)`` (a tuple of tensors), keeping for the backward only
    ``args`` and the outputs of the products in ``ops``
    (``saved_products``); the rest is recomputed there."""
    return _Checkpoint.apply(body, ops, _Kept(), *args)
