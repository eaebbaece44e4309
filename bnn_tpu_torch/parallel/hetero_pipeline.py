"""Heterogeneous-stage pipeline parallelism (counterpart of
``bnn_tpu/parallel/hetero_pipeline.py``).

Lifts the homogeneous pipeline's restriction, so the real ResNet trunk
(widths growing while feature maps shrink) pipelines:

- every stage's state is flattened into one padded f32 row of an
  ``(n_stages, Lmax)`` buffer; each rank holds its own stage's row
  (``Spec('pipe', None)``) and its own stage module;
- activations cross stage boundaries as padded flat ``(micro, Amax)``
  buffers, ``Amax`` the largest per-sample boundary activation;
- where JAX needs ``lax.switch`` on the pipe index to pick the stage body,
  each rank here simply runs its own stage: it unflattens its row into the
  stage's state, applies the module and flattens again.

The row holds the stage's ``state_dict`` (parameters and buffers) in that
order; :attr:`HeteroPipeline.param_mask` is 1 on the parameters' lanes.
Integer buffers (BatchNorm's ``num_batches_tracked``, which its cumulative
mode reads) ride in the row as f32 values: exact below 2**24, and a stage
whose counter reaches that raises rather than round it.

Training works on the flat row directly, as in JAX: an elementwise
optimizer on it is the per-leaf update, and padding lanes have zero
gradient. ``apply(..., return_state=True)`` returns the updated row with
each stage's buffer writes (BatchNorm running statistics in train mode),
committed only on ticks that process a real microbatch, in schedule order:
the sequential per-microbatch EMA. With a ``data`` axis the buffers are
averaged over it (SyncBN-style); the parameter lanes are left as they are
(identical on every data rank). The state path carries no gradient, and
neither do buffers a stage only reads (torch's ``batch_norm`` does not
differentiate its running statistics; JAX's eval-mode BN does).
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .collectives import copy_to, gather_from
from .mesh import Mesh, Spec, _tag, spec_of
from .pipeline import _split_batch, run_schedule

__all__ = ["HeteroPipeline"]

_INT_EXACT = 2 ** 24  # integers f32 holds exactly


def _check_ints(state: Dict[str, torch.Tensor]) -> None:
    for k, v in state.items():
        if not v.is_floating_point() and v.numel() and int(v.abs().max()) >= _INT_EXACT:
            raise ValueError(f"stage buffer {k} = {int(v.abs().max())} is past "
                             f"the f32 row's exact integers (2**24)")


def _flatten(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    if not state:
        return torch.zeros(0)
    return torch.cat([v.detach().reshape(-1).to(torch.float32) for v in state.values()])


class HeteroPipeline:
    """GPipe schedule over arbitrary (non-uniform) pipeline stages.

    Args:
        stages: the sequential stage modules (stage i feeds stage i+1),
            the same on every rank.
        x_shape: per-sample input shape (no batch dimension, NCHW), from
            which every boundary activation's shape is found (one forward
            at batch 1 in eval mode, without gradients).
        mesh: a mesh with a ``pipe`` axis of ``len(stages)`` and optionally
            a ``data`` axis that batch-splits each microbatch
            (:func:`~bnn_tpu_torch.parallel.make_pipeline_mesh`).

    Usage::

        pipe = HeteroPipeline(stages, x_shape=(3, 32, 32), mesh=mesh)
        flat = pipe.flat_params.requires_grad_()   # this rank's row
        y = pipe.apply(flat, x, n_microbatches=4)  # the whole batch
        loss_fn(y, labels).backward()              # flat.grad: its stage's
        states = pipe.unflatten_stage_states(gather_replicated(flat))
    """

    def __init__(self, stages: Sequence[nn.Module], x_shape: Tuple[int, ...],
                 mesh: Mesh, axis: str = "pipe"):
        self.n_stages = len(stages)
        self.mesh, self.axis = mesh, axis
        if mesh.size(axis) != self.n_stages:
            raise ValueError(
                f"mesh {axis} axis {mesh.size(axis)} != {self.n_stages} stages")
        self._keys, self._shapes, self._dtypes, self._params = [], [], [], []
        self.io_shapes: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        flats, masks = [], []
        cur = tuple(x_shape)
        for m in stages:
            state = {k: v for k, v in m.state_dict().items()}
            _check_ints(state)
            params = {k for k, _ in m.named_parameters()}
            self._keys.append(list(state))
            self._shapes.append([tuple(v.shape) for v in state.values()])
            self._dtypes.append([v.dtype for v in state.values()])
            self._params.append(params)
            flats.append(_flatten(state))
            masks.append(torch.cat([
                torch.full((v.numel(),), 1.0 if k in params else 0.0)
                for k, v in state.items()]) if state else torch.zeros(0))
            out = self._out_shape(m, cur)
            self.io_shapes.append((cur, out))
            cur = out
        self.out_shape = self.io_shapes[-1][1]
        self._lmax = max(f.numel() for f in flats)
        self._amax = max(max(math.prod(i), math.prod(o)) for i, o in self.io_shapes)
        s = mesh.index(axis)
        self._stage = copy.deepcopy(stages[s]).to(mesh.device)
        spec = Spec(axis, None)
        #: this rank's (1, Lmax) f32 row of the (n_stages, Lmax) buffer
        self.flat_params = _tag(self._pad(flats[s])[None].to(mesh.device), mesh, spec)
        #: (1, Lmax) 0/1 row, 1.0 exactly on parameter lanes: keep weight
        #: decay off the 0 lanes (running statistics), e.g. by handing the
        #: optimizer ``flat * param_mask`` where it reads the parameters
        self.param_mask = _tag(self._pad(masks[s])[None].to(mesh.device), mesh, spec)
        self._templates = [copy.deepcopy(m) for m in stages]

    @staticmethod
    @torch.no_grad()
    def _out_shape(module: nn.Module, in_shape) -> Tuple[int, ...]:
        modes = [(m, m.training) for m in module.modules()]
        module.eval()
        try:
            p = next(iter(module.state_dict().values()), None)
            dev = p.device if p is not None else torch.device("cpu")
            y = module(torch.zeros((1,) + tuple(in_shape), device=dev))
        finally:
            for m, mode in modes:
                m.training = mode
        return tuple(y.shape[1:])

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.cat([flat, flat.new_zeros(self._lmax - flat.numel())])

    # -- state round trips ---------------------------------------------------

    def _unflatten(self, row: torch.Tensor, i: int) -> Dict[str, torch.Tensor]:
        # one split, whose backward is one concatenation: a slice per leaf
        # would make a zero row of Lmax per leaf in the backward
        sizes = [math.prod(shape) for shape in self._shapes[i]]
        pieces = torch.split(row[:sum(sizes)], sizes) if sizes else ()
        return {k: p.reshape(shape).to(dt) for k, p, shape, dt in
                zip(self._keys[i], pieces, self._shapes[i], self._dtypes[i])}

    def unflatten_stage_states(self, flat_params) -> List[Dict[str, torch.Tensor]]:
        """Per-stage ``state_dict``s from the whole ``(n_stages, Lmax)``
        buffer (``utils.gather_replicated`` of the rows)."""
        if flat_params.shape[0] != self.n_stages:
            raise ValueError(
                f"a buffer of {flat_params.shape[0]} rows for {self.n_stages} "
                "stages: gather the rows first (utils.gather_replicated)")
        return [self._unflatten(flat_params[i], i) for i in range(self.n_stages)]

    def stage_modules(self, flat_params) -> List[nn.Module]:
        """The stage modules with the states of ``flat_params`` (whole)."""
        mods = []
        for m, st in zip(self._templates, self.unflatten_stage_states(flat_params)):
            m = copy.deepcopy(m)
            m.load_state_dict({k: v.detach() for k, v in st.items()})
            mods.append(m)
        return mods

    # -- pipelined forward ---------------------------------------------------

    def _branch(self, row: torch.Tensor, xflat: torch.Tensor, micro: int):
        """This rank's stage on its (padded, flat) input: ``(new row with
        the stage's buffer writes, padded flat output)``."""
        s = self.mesh.index(self.axis)
        in_shape, _ = self.io_shapes[s]
        state = self._unflatten(row, s)
        # buffers are copies the forward may write in place; parameters are
        # slices of the row, so its gradient reaches them
        state = {k: (v if k in self._params[s] else v.detach().clone())
                 for k, v in state.items()}
        x = xflat[:, :math.prod(in_shape)].reshape((micro,) + in_shape)
        y = torch.func.functional_call(self._stage, state, (x,)).reshape(micro, -1)
        with torch.no_grad():
            new = row.detach().clone()
            n = sum(math.prod(sh) for sh in self._shapes[s])
            new[:n] = _flatten(state)
        return new, torch.nn.functional.pad(y.to(xflat.dtype),
                                            (0, self._amax - y.shape[1]))

    def _local(self, flat_params: torch.Tensor) -> torch.Tensor:
        if self.axis in spec_of(flat_params).axes(0) or flat_params.shape[0] == 1:
            return flat_params[0]
        return flat_params[self.mesh.index(self.axis)]

    def apply(self, flat_params: torch.Tensor, x: torch.Tensor, *,
              n_microbatches: int, return_state: bool = False):
        """Pipelined forward of ``x`` (``(batch, *x_shape)``, the whole batch
        on every rank); returns the last stage's output for the whole batch
        on every rank, differentiable w.r.t. this rank's row of
        ``flat_params`` (which holds the whole batch's gradient once every
        rank has called ``backward`` on the same loss).

        ``return_state=True`` also returns this rank's updated ``(1, Lmax)``
        row carrying its stage's buffer writes, exactly the sequential
        per-microbatch EMA; no gradient flows through it."""
        mesh, axis = self.mesh, self.axis
        s = mesh.index(axis)
        if tuple(x.shape[1:]) != self.io_shapes[0][0]:
            # the flat pad / reshape would take any smaller input and read it
            # (plus zeros) into the declared layout: finite garbage
            raise ValueError(
                f"input sample shape {tuple(x.shape[1:])} != pipeline's "
                f"declared x_shape {self.io_shapes[0][0]}")
        batch = x.shape[0]
        xf = x.reshape(batch, -1).to(torch.float32)
        xf = torch.nn.functional.pad(xf, (0, self._amax - xf.shape[1]))
        xs, micro, n_data = _split_batch(xf, mesh, n_microbatches)
        local = micro // n_data
        flat0 = self._local(flat_params)
        if n_data > 1:
            flat0 = copy_to(flat0, mesh.group("data"))
        carried = [flat0.detach()]

        def step(t, inp):
            # VALUE: the carried row (running statistics compound over the
            # microbatches). GRADIENT: w.r.t. the original row
            eff = flat0 + (carried[0] - flat0).detach()
            new, out = self._branch(eff, inp, local)
            if 0 <= t - s < n_microbatches:  # a real microbatch: commit
                carried[0] = new
            return out

        ys = run_schedule(step, xs, mesh, axis, n_microbatches)
        if n_data > 1:
            ys = gather_from(ys, mesh.group("data"), 1)
        n_out = math.prod(self.out_shape)
        y = ys.reshape(batch, self._amax)[:, :n_out].reshape((batch,) + self.out_shape)
        if not return_state:
            return y
        new = carried[0]
        _check_ints({k: v for k, v in self._unflatten(new, s).items()
                     if not v.is_floating_point()})
        if n_data > 1:
            # average the buffers over the data replicas; the parameters
            # are the same on each
            avg = new.clone()
            dist.all_reduce(avg, group=mesh.group("data"))
            mask = self.param_mask[0] > 0
            new = torch.where(mask, new, avg / n_data)
        return y, _tag(new[None], mesh, Spec(axis, None))
