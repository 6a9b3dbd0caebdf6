"""ZeRO-3 placement of a model's params and optimizer state over the
``data`` and ``model`` axes of a
:class:`~repro_torch.launch.mesh.ProcessMesh`, and the seams of the sharded
fused step.

At rest every param leaf is held as this rank's block: split along the dim
that ``rules.param_pspecs`` shards over ``data`` and along the dim it shards
over ``model`` (a :class:`Place`), whole along a dim the axis does not
divide (the rules' shape guard).  The other leaves (norm scales, biases,
and a vector the rules would split over ``model``, mamba's conv bias) are
whole on every rank.  Params are replicated across pods.  AdaLomo's
factored state shards with the rows and columns it describes, as the
reference's ``opt_pspecs``: r takes its param's row split, c its column
split; an unfactored v is split as its param.

The fused step (``core/fused.py``) calls the seams:

  * :meth:`Zero3.gather` / :meth:`Zero3.layer` — the whole tensors of the
    outer leaves (once a step) and of one layer (before its forward and
    before its re-run), gathered in the param dtype over ``data`` and then
    ``model``; the MoE expert stacks keep their expert split over ``model``
    (expert parallelism) and are gathered over ``data`` only;
  * :meth:`Zero3.scatter` — a layer's (or the outer leaves') gradients
    summed over the ranks whose tokens differ, landing as each leaf rests:
    reduce-scattered over ``data`` and then ``model`` along the split dims,
    all-reduced over an axis that does not split the leaf, then over
    ``pod``; fp32 sums in rank order, rounded once to the gradient's dtype;
  * :meth:`Zero3.shards` — the :class:`TensorShard` of each leaf: the
    groups holding the other row and column blocks of its matrices, which
    the AdaLomo rule takes to sum its statistics over the ranks;
  * :meth:`Zero3.rows` — this rank's rows (``pod`` × ``data``) and
    sequence tile (``model``) of a global batch, a modality prefix's rows
    counted ahead of the tokens', an encoder's frames tiled apart from
    them.

The sharded serving steps (``serve/sharded.py``) take the same gathers and
rows, and a cache rests as ``rules.cache_pspecs`` places it
(:meth:`Zero3.cache_block`, :meth:`Zero3.slot_block`): rows over ``pod`` ×
``data`` and dim 2 of every ``[L, B, X, ...]`` leaf (a ring's slots,
mamba's SSM heads or conv taps, whisper's frames) over ``model``.

Nothing here keeps a gathered tensor: a layer's whole weights live while
its forward or its re-run does.

``Zero3(optimized=False)`` is the paper-faithful baseline plan, the
counterpart of the reference's ``MeshSpec.optimized=False`` (its dry run
installs no activation policy and passes no gradient or param
constraint).  Params and optimizer state rest where the optimized plan
rests them; what changes:

  * no sequence tile: :meth:`Zero3.rows` cuts the rows over ``pod`` ×
    ``data`` only, and every ``model`` rank runs its rows' whole sequence
    (its policy, ``ActPolicy(tiles=False)``, shards no activation; it
    keeps the batch's sums and means over the ``pod`` × ``data`` ranks,
    which the loss's global token count and the MoE router's statistics
    need);
  * the expert stacks are gathered whole over ``model`` too (every rank
    runs every expert on its rows);
  * :meth:`Zero3.scatter` all-reduces each whole gradient over the ranks
    whose rows differ (``pod`` × ``data``: the ``model`` ranks computed the
    same gradient, so it is summed over the batch ranks only) and keeps
    this rank's block of the sum.  The AdaLomo update then runs on the
    block through K1/K2's sharded entries, as in the optimized plan.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.tree import (pytree_leaves, pytree_unflatten,
                                   tree_flatten_with_path, tree_leaves,
                                   tree_map)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.act import ActPolicy
from repro_torch.sharding.rules import (EXPERT_LEAF, MeshAxes, P,
                                       cache_pspecs, data_dim,
                                       make_grad_constraint,
                                       make_param_constraint,
                                       make_residual_constraint, model_dim,
                                       param_pspecs)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Place:
    """Where a tensor rests: the dim split over ``data`` and the dim split
    over ``model`` (None: whole along that axis); ``ep``: the ``model``
    split is kept at use (an expert stack's expert dim)."""

    data: Optional[int] = None
    model: Optional[int] = None
    ep: bool = False

    @property
    def whole(self) -> bool:
        return self.data is None and self.model is None


WHOLE = Place()


class TensorShard(NamedTuple):
    """One rank's block of a tensor whose trailing two dims form the
    matrix: ``rows`` the group holding the other row blocks of the same
    columns (None: the rows are whole here), ``cols`` the group holding the
    other column blocks, ``group`` the ranks holding all the blocks, and
    ``n_total`` the whole matrix's element count."""

    rows: object
    cols: object
    n_total: int
    group: object

    @property
    def axis(self) -> int:
        """-2: split by rows only, -1: by columns only, 0: both."""
        if self.cols is None:
            return -2
        return -1 if self.rows is None else 0

    def sum(self, t: Tensor) -> Tensor:
        """The sum of ``t`` over the ranks holding this tensor's blocks."""
        return C.all_reduce(t, self.group)

    def over_rows(self, t: Tensor) -> Tensor:
        """The sum of ``t`` over the ranks holding the other row blocks
        (``t`` itself when the rows are whole)."""
        return t if self.rows is None else C.all_reduce(t, self.rows)

    def over_cols(self, t: Tensor) -> Tensor:
        """The sum of ``t`` over the ranks holding the other column
        blocks (``t`` itself when the columns are whole)."""
        return t if self.cols is None else C.all_reduce(t, self.cols)

    def whole_mn(self, m: int, n: int) -> tuple:
        """The whole matrix's ``(rows, columns)`` from this block's."""
        size = lambda g: 1 if g is None else C.world_size(g)  # noqa
        return m * size(self.rows), n * size(self.cols)


def _shift(d: Optional[int], ndim: int, kind: str) -> Optional[int]:
    """A param dim's place in its factored state: ``r`` (shape[:-1]) or
    ``c`` (shape[:-2] + shape[-1:]); None where the state drops it."""
    if d is None:
        return None
    if kind == "r":
        return None if d == ndim - 1 else d
    if d == ndim - 2:
        return None
    return ndim - 2 if d == ndim - 1 else d


def _state_places(pl: Place, ndim: int, state):
    """Places of a per-tensor state's tensors (a tuple, or a bare tensor)."""
    if not isinstance(state, tuple):
        return pl
    fields = getattr(state, "_fields", None)
    out = []
    for i, t in enumerate(state):
        if t is None:
            out.append(None)
            continue
        name = fields[i] if fields else None
        if name in ("r", "c"):
            out.append(Place(_shift(pl.data, ndim, name),
                             _shift(pl.model, ndim, name), pl.ep))
        else:                     # v, moments: the param's shape
            out.append(pl)
    return type(state)(*out) if fields else tuple(out)


def param_places(params, axes: MeshAxes):
    """The :class:`Place` of every param leaf, by the rules."""
    specs = param_pspecs(params, axes)
    return {k: _places(specs[k], k) for k in specs}


def _places(spec, path: str):
    if isinstance(spec, dict):
        return {k: _places(spec[k], f"{path}/{k}") for k in spec}
    md = model_dim(spec)
    return Place(data_dim(spec), md,
                 md is not None and bool(EXPERT_LEAF.search(path)))


def rest_pspecs(params, axes: MeshAxes):
    """``rules.param_pspecs`` with every vector (one dim past a stack's
    leading one: mamba's conv bias) whole over ``model``: the optimizer
    rules' sharded forms take matrices, and a vector is a few kB.  The
    reference's ``param_pspecs`` splits such a vector over ``model``; the
    port rests it whole (``launch/dryrun.py`` reckons with this too)."""
    specs = param_pspecs(params, axes)

    def whole(ax):
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a != "model") or None
        return None if ax == "model" else ax

    return {key: tree_map(
        lambda sp, t, lead=int(key == "stacks"): sp
        if len(t.shape) - lead >= 2 else P(*map(whole, sp)),
        specs[key], params[key]) for key in specs}


def rest_places(params, axes: MeshAxes):
    """The :class:`Place` every param leaf rests at on the mesh of
    ``axes``: those of :func:`rest_pspecs`, where a model axis of 1 splits
    nothing (the data axis' plan alone), nor does a data axis of 1 beside
    a model axis (its gathers and sums would be copies; a mesh of data
    alone keeps its one-rank split, the sharded path on one card)."""
    specs = rest_pspecs(params, axes)
    dims = {k: _places(specs[k], k) for k in specs}
    if axes.size(axes.tp) == 1:
        dims = tree_map(lambda pl: Place(pl.data), dims)
    elif axes.size(axes.fsdp) == 1:
        dims = tree_map(lambda pl: Place(None, pl.model, pl.ep), dims)
    return dims


def leaf_places(places, shapes, opt_state) -> list:
    """The :class:`Place` of every tensor of ``(params, opt_state)`` in
    ``pytree_leaves`` order, from the params' ``places`` and full
    ``shapes``: a state tensor follows its param (a factored r its rows, c
    its columns); ``OptState.step`` is whole."""
    p = [pl for _, pl in tree_flatten_with_path(places)]
    s = pytree_leaves(tree_map(lambda pl, shp, st: _state_places(
        pl, len(shp), st), places, shapes, opt_state.moments))
    return p + [WHOLE] + s


class Zero3:
    """The ZeRO-3 plan of one model on ``mesh``, from its full params'
    paths and shapes (tensors of any device, ``meta`` included).

    ``gathers`` counts the leaves gathered by :meth:`gather`, by
    ``(axis, "expert" | "dense")``: an expert stack is never gathered over
    ``model``.  ``tile`` is this rank's ``(B/dp, T)`` of the last batch
    :meth:`rows` cut while the model axis is larger than 1 (else None):
    ``T = (prefix + S) / tp`` rows, where ``prefix`` is the model's
    modality prefix (``n_prefix_tokens``, 0 without one), whose rows come
    before the tokens' in the sequence ``model`` tiles; ``frame_tile`` is
    its ``(B/dp, F/tp)`` of an encoder's frames (None without them).
    ``optimized=False``: the baseline plan (module docstring), whose
    ``tile`` and ``frame_tile`` stay None."""

    def __init__(self, mesh, params, *, prefix: int = 0,
                 optimized: bool = True):
        self.mesh = mesh
        self.prefix = prefix
        self.optimized = optimized
        self.axes = MeshAxes(mesh)
        self.dims = rest_places(params, self.axes)
        self.shapes = tree_map(lambda t: tuple(t.shape), params)
        self.data = mesh.group("data")
        self.model = (mesh.groups.get("model") if mesh.size("model") > 1
                      else None)
        self.pod = mesh.groups.get("pod") if mesh.size("pod") > 1 else None
        self.batch = mesh.batch_group
        self.world = mesh.groups.get("world", mesh.batch_group)
        self.matrix = mesh.groups.get("matrix", self.data)
        self.tp = mesh.size("model")
        self.policy = ActPolicy(mesh, self.axes, tiles=optimized)
        self.gathers = collections.Counter()
        self.tile = None
        self.frame_tile = None

    # ---------------- placement ----------------
    def leaf_dims(self, opt_state) -> list:
        """The :class:`Place` of every tensor of ``(params, opt_state)``,
        in checkpoint leaf order (``pytree_leaves``)."""
        return leaf_places(self.dims, self.shapes, opt_state)

    def tree_dims(self, tree) -> list:
        """:meth:`leaf_dims` of a ``(params, opt_state)`` tree."""
        return self.leaf_dims(tree[1])

    def local(self, full: Tensor, pl: Place) -> Tensor:
        """This rank's block of a whole tensor."""
        if pl.data is not None:
            full = C.shard(full, pl.data, self.data)
        if pl.model is not None and self.model is not None:
            full = C.shard(full, pl.model, self.model)
        return full

    def block(self, pl: Place) -> tuple:
        """``[(dim, parts, index)]``: the dims this rank's block of a
        tensor placed at ``pl`` cuts, into how many parts, and which."""
        out = []
        if pl.data is not None and self.mesh.size("data") > 1:
            out.append((pl.data, self.mesh.size("data"),
                        self.mesh.coords.get("data", 0)))
        if pl.model is not None and self.tp > 1:
            out.append((pl.model, self.tp, self.mesh.tile_index))
        return out

    def block_group(self, pl: Place):
        """The group holding the blocks of a tensor placed at ``pl``, in
        the order of :meth:`block`'s cuts, data-major (None: whole)."""
        cuts = self.block(pl)
        if len(cuts) == 2:
            return self.matrix
        if not cuts:
            return None
        return self.data if cuts[0][0] == pl.data else self.model

    def shard_tree(self, tree, opt_state, *, in_place: bool = False
                   ) -> tuple:
        """``(params, opt_state)`` of whole tensors -> this rank's resting
        blocks (new contiguous tensors for the split leaves).
        ``in_place``: the params' own dicts take the blocks, leaf by leaf,
        so each whole tensor goes as its block is cut and the whole model
        and every block are never alive at once (for a caller that owns
        the dicts, as ``StepProgram.init``)."""
        places = self.leaf_dims(opt_state)
        if not in_place:
            return pytree_unflatten(tree, [
                self.local(t, pl)
                for t, pl in zip(pytree_leaves(tree), places)])
        params, state = tree
        self._cut_in_place(params, self.dims)
        n = len(pytree_leaves(params))
        return params, pytree_unflatten(state, [
            self.local(t, pl)
            for t, pl in zip(pytree_leaves(state), places[n:])])

    def place_params(self, params):
        """Whole params -> this rank's resting blocks, cut leaf by leaf in
        the params' own dicts (so no whole model and its blocks are held at
        once), which are returned."""
        self._cut_in_place(params, self.dims)
        return params

    def _cut_in_place(self, params: dict, dims: dict) -> None:
        for k in sorted(params):
            if isinstance(params[k], dict):
                self._cut_in_place(params[k], dims[k])
            else:
                params[k] = self.local(params[k], dims[k])

    # ---------------- step seams ----------------
    def _gather_one(self, t: Tensor, pl: Place, drop: int) -> Tensor:
        kind = "expert" if pl.ep else "dense"
        if pl.data is not None:
            t = C.all_gather(t, pl.data - drop, self.data)
            self.gathers["data", kind] += 1
        if pl.model is not None and self.model is not None and (
                not pl.ep or not self.optimized):
            t = C.all_gather(t, pl.model - drop, self.model)
            self.gathers["model", kind] += 1
        return t

    def gather(self, local, dims, *, drop: int = 0):
        """Whole tensors of a subtree (``dims`` its places tree; ``drop``
        leading dims already indexed away), expert stacks still split over
        ``model`` in the optimized plan."""
        return tree_map(lambda t, pl: self._gather_one(t, pl, drop), local,
                        dims)

    def layer(self, stacked, dims, i: int):
        """Layer ``i`` of a stacked subtree, whole."""
        return self.gather(tree_map(lambda t: t[i], stacked), dims, drop=1)

    def _scatter_one(self, g: Tensor, pl: Place, drop: int) -> Tensor:
        if not self.optimized:
            # the whole sum (fp32, rank order, rounded once), then this
            # rank's block of it as a tensor of its own
            g = C.all_reduce_groups(g, [self.batch])
            for dim, parts, k in self.block(pl):
                n = g.shape[dim - drop] // parts
                g = g.narrow(dim - drop, k * n, n)
            return g.clone(memory_format=torch.contiguous_format)
        if pl.whole:
            return C.all_reduce(g, self.world)
        f32 = torch.float32
        then = []                  # axes summed whole, after the scatters
        if pl.data is not None:
            g = C.reduce_scatter(g, pl.data - drop, self.data, dtype=f32)
        else:
            then.append(self.data)
        if pl.model is None:
            then.append(self.model)
        elif not pl.ep and self.model is not None:
            g = C.reduce_scatter(g, pl.model - drop, self.model, dtype=f32)
        # (an expert stack's gradient is already its experts' whole)
        return C.all_reduce_groups(g, then + [self.pod])

    def scatter(self, grads, dims, *, drop: int = 0):
        """Whole-tensor gradients of this rank's tokens -> the sum over all
        ranks, as each leaf rests (module docstring)."""
        return tree_map(lambda g, pl: self._scatter_one(g, pl, drop).to(
            g.dtype), grads, dims)

    def shards(self, dims, shapes, *, drop: int = 0):
        """The :class:`TensorShard` (or None: held whole, or split along
        independent leading dims only) of every leaf of a subtree."""
        def one(pl, shp):
            shp = shp[drop:]
            n = len(shp)
            groups = {}
            for d, grp in ((pl.data, self.data), (pl.model, self.model)):
                if d is None or grp is None or d - drop < n - 2:
                    continue      # whole, or an independent leading dim
                groups["rows" if d - drop == n - 2 else "cols"] = grp
            if not groups:
                return None
            rows, cols = groups.get("rows"), groups.get("cols")
            both = self.matrix if rows is not None and cols is not None \
                else (rows if cols is None else cols)
            return TensorShard(rows=rows, cols=cols,
                               n_total=shp[-2] * shp[-1], group=both)
        return tree_map(one, dims, shapes)

    def tree_shards(self):
        """:meth:`shards` of the whole params tree (``Opt.step``'s
        ``shards``): a stack's leaves by their per-layer shape."""
        return {key: ({name: self.shards(self.dims[key][name],
                                         self.shapes[key][name], drop=1)
                       for name in self.dims[key]} if key == "stacks"
                      else self.shards(self.dims[key], self.shapes[key]))
                for key in self.dims}

    def seams(self, stack: str) -> dict:
        """The keywords of ``core.fused.stack_backward_update`` for one
        stack: ``layer_fn`` (the gather, ``rules.make_param_constraint``),
        ``grad_fn`` (the reduce-scatter, ``rules.make_grad_constraint``)
        and ``shards``."""
        return dict(layer_fn=make_param_constraint(self)(stack),
                    grad_fn=make_grad_constraint(self)(stack),
                    shards=self.shards(self.dims["stacks"][stack],
                                       self.shapes["stacks"][stack], drop=1))

    def residual_fn(self):
        """``rules.make_residual_constraint``: the check that a saved
        layer input is this rank's tile."""
        return make_residual_constraint(self)

    def sum_once(self, terms, *, per_term: bool = False):
        """The sum over the whole model of per-leaf fp32 scalars ``terms``
        (``[(place, value)]``, each the sum over this rank's block), each
        element counted once: a block held by several ranks along an axis
        that does not split it is counted on the ranks at index 0 of that
        axis only, and one fixed-order sum over the ``matrix`` group adds
        the blocks; whole leaves are added once, after it.  ``per_term``:
        the values are fp32 vectors of any fixed lengths, and the result is
        each term's own sum over the ranks (a list in the terms' order),
        all in one collective.  The same bits on every rank."""
        md = self.mesh.coords.get("data", 0)
        mm = self.mesh.tile_index

        def counted(pl):
            return (pl.data is not None or md == 0) and (
                pl.model is not None or mm == 0)

        if per_term:
            return self._sum_each(terms, counted)
        split, whole = [], []
        for pl, v in terms:
            if pl.whole:
                whole.append(v)
            elif counted(pl):
                split.append(v)
        part = (torch.stack(split).sum() if split
                else torch.zeros((), device=self.mesh.device))
        total = C.all_reduce(part.reshape(1), self.matrix)[0]
        return total + (torch.stack(whole).sum() if whole else 0.0)

    def _sum_each(self, terms, counted) -> list:
        """:meth:`sum_once`'s ``per_term`` form: the split terms' vectors
        (zeros where not counted) joined, summed over ``matrix`` at once
        and cut apart again; whole terms as they are."""
        split = [i for i, (pl, _) in enumerate(terms) if not pl.whole]
        out = [v for _, v in terms]
        if not split:
            return out
        parts = []
        for i in split:
            pl, v = terms[i]
            parts.append((v if counted(pl) else torch.zeros_like(v))
                         .reshape(-1))
        total = C.all_reduce(torch.cat(parts), self.matrix)
        pos = 0
        for i in split:
            n = out[i].numel()
            out[i] = total[pos:pos + n].reshape(out[i].shape)
            pos += n
        return out

    def rows(self, batch: dict) -> dict:
        """This rank's rows and sequence tile of every leaf of a global
        batch: the leading dim split over ``pod`` × ``data`` when it
        divides (else whole) and, with a model axis, the sequence tiled
        over ``model``.  The tiled sequence is the model's whole input, a
        modality prefix's ``prefix`` rows (``prefix_embed``) before the
        ``S`` tokens: tile ``i`` is its rows ``[iT, (i+1)T)``,
        ``T = (prefix + S) / tp``, so it takes ``prefix_embed``'s rows
        ``[iT, min((i+1)T, prefix))`` and the token leaves' (tokens,
        labels, positions, segment ids, the loss mask) rows
        ``[max(iT - prefix, 0), max((i+1)T - prefix, 0))``; either may be
        empty.  An encoder's ``frames [B, F, d]`` are a sequence of their
        own, tiled along their own length: tile ``i`` is frames
        ``[iF/tp, (i+1)F/tp)``; where ``tp`` does not divide ``F`` (whisper's
        1500 frames on a model axis of 16) every rank keeps them whole; a
        batch of frames alone (an encoder-decoder's prefill) sets no
        ``tile``.  A 1-D leaf (``prefix_len``) keeps its rows only.  Raises
        ``ValueError``, naming the leaf, where ``tp`` does not divide
        ``prefix + S``, or a ``prefix_embed`` is not ``prefix`` rows
        long."""
        out = {k: self._batch_rows(x) for k, x in batch.items()}
        if self.tp == 1 or not self.optimized:
            return out
        P = self.prefix
        pre = out.get("prefix_embed")
        if (pre is None) != (P == 0) or (pre is not None
                                         and pre.shape[1] != P):
            raise ValueError(
                f"a batch's prefix_embed "
                f"{None if pre is None else tuple(pre.shape)} does not hold "
                f"the {P} prefix rows the plan tiles")
        tokens, frames = out.get("tokens"), out.get("frames")
        lo = hi = 0
        if tokens is not None:
            n = tokens.shape[1]
            lo, hi = self._span(P + n, "tokens", tokens.shape,
                                f"their sequence of P + S = {P} + {n} "
                                f"= {P + n} rows")
        if frames is not None:
            flo, fhi = ((0, frames.shape[1]) if frames.shape[1] % self.tp
                        else self._span(frames.shape[1], "frames",
                                        frames.shape,
                                        f"their {frames.shape[1]} frames"))
        for k, x in out.items():
            if k == "prefix_embed":
                out[k] = x[:, min(lo, P):min(hi, P)]
            elif k == "frames":
                out[k] = x[:, flo:fhi]
            elif x.ndim >= 2:
                out[k] = x[:, max(lo - P, 0):max(hi - P, 0)]
        self.tile = None if tokens is None else (tokens.shape[0], hi - lo)
        self.frame_tile = (None if frames is None
                           else (frames.shape[0], fhi - flo))
        return out

    def slot_block(self, W: int) -> tuple:
        """``(lo, hi)``: this rank's block of dim 2 of a cache leaf ``[L,
        B, W, ...]`` (a ring's ``W`` slots, mamba's ``W`` heads or conv
        taps, whisper's ``W`` frames), split over ``model`` where the axis
        divides ``W`` (``rules.cache_pspecs``), else all of it."""
        if self.tp > 1 and W % self.tp == 0 and W > 1:
            n = W // self.tp
            return self.mesh.tile_index * n, (self.mesh.tile_index + 1) * n
        return 0, W

    def cache_block(self, cache: dict, batch_size: int) -> dict:
        """This rank's block of a whole cache of ``batch_size`` rows (the
        ``[L, B, X, ...]`` tensors, ``pos [W]``, ``cur``), where
        ``rules.cache_pspecs`` places it: the rows (dim 1) over ``pod`` ×
        ``data`` and dim 2 over ``model``, each where it divides; ``pos``
        and ``cur`` whole.  A split leaf's block is a
        tensor of its own."""
        specs = cache_pspecs(cache, self.axes, batch_size)
        out = {}
        for key, t in cache.items():
            block = t
            for dim, ax in enumerate(specs[key]):
                parts, i = ((self.tp, self.mesh.tile_index) if ax == "model"
                            else (self.mesh.batch_size,
                                  self.mesh.batch_index))
                if ax is not None and parts > 1:
                    n = block.shape[dim] // parts
                    block = block.narrow(dim, i * n, n)
            out[key] = (t if block is t else
                        block.clone(memory_format=torch.contiguous_format))
        return out

    def _batch_rows(self, x: Tensor) -> Tensor:
        """This rank's rows of a batch leaf's leading dim (``pod`` ×
        ``data``), whole where the dim does not divide."""
        w = self.mesh.batch_size
        if x.ndim == 0 or x.shape[0] % w or x.shape[0] <= 1:
            return x
        k = x.shape[0] // w
        i = self.mesh.batch_index
        return x[i * k:(i + 1) * k]

    def _span(self, n: int, leaf: str, shape, rows: str) -> tuple:
        """``[iT, (i+1)T)``, ``T = n / tp``: this rank's tile of a
        sequence of ``n`` rows, that of the batch leaf ``leaf`` of
        ``shape`` (``rows`` says what they are, for the error)."""
        if n % self.tp:
            raise ValueError(f"a batch's {leaf} {tuple(shape)}: {rows} do "
                             f"not divide over a model axis of {self.tp}")
        T = n // self.tp
        i = self.mesh.tile_index
        return i * T, (i + 1) * T


def tree_sqsums(tree, places) -> list:
    """``[(place, Σg²)]`` of a gradient tree and its places tree."""
    return [(pl, torch.sum(torch.square(g.to(torch.float32))))
            for g, (_, pl) in zip(tree_leaves(tree),
                                  tree_flatten_with_path(places))]
