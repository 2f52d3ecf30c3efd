"""Spatial (height-axis) sharding: train and infer past one card's memory.

Counterpart of svbrdf_tpu/parallel/spatial.py. `--shard-spatial N` splits
every image's height over the N ranks of a group (parallel/mesh.init_group,
one card a rank): rank r holds rows r * H/N .. (r + 1) * H/N - 1 of every
activation, the parameters are replicated, and the batch is not split. In
the JAX package XLA's SPMD partitioner derives the convolutions' halo
exchanges and the cross-shard reductions; torch has no partitioner, so this
module writes them out, each as a torch.autograd.Function whose backward is
the true adjoint of its forward:

  - halo_rows: a convolution's rows from the neighbouring ranks (zero rows
    at the image's top and bottom, the zero pad of one device), built on an
    all_gather of each rank's boundary rows; its backward returns each
    received row's cotangent to its owner, who adds it;
  - shard_sum: an all-reduce-sum of f32 partial sums (the InstanceNorm
    statistics, the global track's channel means); backward the same;
  - gather_rows: the whole height from every rank's rows, for the levels
    too short to split (all_gather forward, all_reduce-then-my-slot
    backward; gloo's point-to-point calls and reduce_scatter need not take
    CUDA tensors, so every collective here is an all_gather or an
    all_reduce, which NCCL and gloo both run on the card).

The sharded forward is a walk over the models' own modules (spatial_forward),
not a context that the layers consult: the layers stay the plain single
device's code, so the unsharded main path cannot change by a bit, and every
sharded rule sits in one module beside its collective. The walk reads the
same parameters (the same nn.Modules, the same state_dict keys, so a
spatial checkpoint loads strictly into a plain model and the reverse) and
calls the modules' own per-pixel pieces (Merge, GlobalTrack, the head). Per
layer:

  - encoder 4x4 stride 2 pad 1, and the multi-view head's 3x3 pad 1: a halo
    of one row above and one below, then the convolution with only the
    width padded;
  - decoder (upsample, ZeroPad(1, 2, 1, 2), 4x4 conv, twice): one halo row
    each side exchanged before the upsample (half the rows of one after
    it), the upsampled halo cut to the one row above and two below the
    first convolution reads; then a halo of one above and two below of its
    output for the second;
  - InstanceNorm and the channel-mean tap: the sums of x and x^2 over the
    shard in f32, all-reduced in one call, over the global H * W;
  - append_coords: the rank's rows of the global linspace;
  - dropout (dec8-dec6): a mask drawn for the level's global shape from
    torch's default generator, which every rank holds alike (SpatialTrainStep
    broadcasts rank 0's state), cut to the rank's rows: N ranks draw what
    one device draws;
  - a level whose height does not split into at least a row a rank (at
    depth 8 and 256^2 over 2 ranks, enc8 and dec8): its input is gathered
    and the level runs replicated through the module's own forward; the
    decoder's output is cut to the rank's rows again where it splits.

The loss runs per shard with the kernels' row offset and global height
(spatial_rendering_loss), so each rank holds its share; a rank backpropagates
its own share, and the parameter gradients are then summed over the group
(step.reduce_gradients with scale 1).

Not ported: _require_fold (:49-65), which guards an XLA mispartitioning of
the TPU-only lhs-dilated decoder conv; the port's decoder is upsample, pad
and conv (the fold form's math) and has no such form.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.nn import functional as F

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.models import layers as L
from svbrdf_tpu_torch.models.multi_view import MultiViewModel
from svbrdf_tpu_torch.models.single_view import head_to_svbrdf
from svbrdf_tpu_torch.ops import render_fused, sampling
from svbrdf_tpu_torch.parallel import mesh
from svbrdf_tpu_torch.parallel.step import (PrepConfig, TrainStep, _eval_mode,
                                            _rows, _span, compute_dtype,
                                            loss_rows, prepare_rows,
                                            reduce_gradients,
                                            replicate_training_state)


def make_spatial_mesh(n_devices: int,
                      device_type: str = "cuda") -> List[torch.device]:
    """The devices of an n-rank spatial group, rank r on the r-th
    (mesh.make_mesh: more ranks than cards raises, never truncates; the
    group itself is mesh.init_group's)."""
    return mesh.make_mesh(n_devices, device_type)


def _world(group) -> int:
    return 1 if group is None else group.world


def _rank(group) -> int:
    return 0 if group is None else group.rank


class _AllGather(torch.autograd.Function):
    """Stack every rank's tensor, (world, ...), by all_gather; adjoint: the
    all-reduce-sum of the cotangents, then this rank's slot."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = group.rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.world)]
        dist.all_gather(parts, x)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad[ctx.rank], None


class _ShardSum(torch.autograd.Function):
    """All-reduce-sum of every rank's partial sums; adjoint: the
    all-reduce-sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, grad):
        total = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total)
        return total, None


def shard_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of every rank's `x` (differentiable, see
    _ShardSum); `x` itself at world 1."""
    return x if _world(group) == 1 else _ShardSum.apply(x, group)


def halo_rows(x: torch.Tensor, above: int, below: int, group,
              dim: int = 2) -> torch.Tensor:
    """`x`, this rank's rows along `dim`, with `above` rows of the rank
    above prepended and `below` rows of the rank below appended; zero rows
    at the image's top and bottom edges (the zero pad of one device).
    Each rank's boundary rows travel by one all_gather (_AllGather, whose
    backward adds each received row's cotangent back at its owner)."""
    rows = x.shape[dim]
    if rows < max(above, below):
        raise ValueError(f"a halo of {above} / {below} rows needs at least "
                         f"that many rows a rank, got {rows}")
    world, rank = _world(group), _rank(group)

    def zeros(n):
        shape = list(x.shape)
        shape[dim] = n
        return x.new_zeros(shape)

    if world == 1:
        return torch.cat([zeros(above), x, zeros(below)], dim)
    edges = torch.cat([x.narrow(dim, 0, below),
                       x.narrow(dim, rows - above, above)], dim)
    parts = _AllGather.apply(edges, group)
    top = (parts[rank - 1].narrow(dim, below, above) if rank > 0
           else zeros(above))
    bottom = (parts[rank + 1].narrow(dim, 0, below) if rank < world - 1
              else zeros(below))
    return torch.cat([top, x, bottom], dim)


def gather_rows(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """The whole height along `dim` from every rank's rows of it, on every
    rank (_AllGather)."""
    if _world(group) == 1:
        return x
    return torch.cat(list(_AllGather.apply(x, group).unbind(0)), dim)


def take_rows(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """This rank's rows along `dim` of a whole height held by every rank; a
    slice, whose autograd backward (the cotangent zero-padded to the whole
    height) is its adjoint."""
    n = x.shape[dim] // _world(group)
    lo = _rank(group) * n
    return _rows(x, lo, lo + n, dim)


def splits(height: int, group) -> bool:
    """Whether maps `height` rows tall are split over the group: into an
    equal share of at least a row a rank."""
    world = _world(group)
    return height % world == 0 and height >= world


class _Shards:
    """The group as the walk sees it: which heights split, this rank's rows
    of a whole map, and a whole map from the rows."""

    def __init__(self, group):
        self.group = group

    def split(self, height: int) -> bool:
        return splits(height, self.group)

    def mine(self, x, height: int, dim: int = 2):
        return take_rows(x, self.group, dim) if self.split(height) else x

    def whole(self, x, height: int, dim: int = 2):
        return gather_rows(x, self.group, dim) if self.split(height) else x


def _mean_and_sums(x, height: int, sh: _Shards, squares: bool):
    """The channel means of `x` (the rank's rows of a map `height` rows
    tall) over the whole map, in f32, and with `squares` the means of x^2:
    the shard's sums all-reduced in one call, over the global H * W."""
    xf = x.float()
    sums = [xf.sum(dim=(2, 3))]
    if squares:
        sums.append(torch.square(xf).sum(dim=(2, 3)))
    sums = torch.cat(sums, dim=1)
    if sh.split(height):
        sums = shard_sum(sums, sh.group)
    means = sums / float(height * x.shape[3])
    c = x.shape[1]
    return means[:, :c], (means[:, c:] if squares else None)


def _norm_merge(unit, x, height: int, g, sh: _Shards):
    """A block's tail on its conv's output rows: the pre-norm channel-mean
    tap, InstanceNorm on the whole map's statistics, merge."""
    norm = unit.norm
    mean, mean_sq = _mean_and_sums(x, height, sh, norm is not None)
    if norm is not None:
        xf = x.float()
        var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
        y = ((xf - mean[:, :, None, None])
             * torch.rsqrt(var + norm.eps)[:, :, None, None])
        y = y * norm.weight[:, None, None] + norm.bias[:, None, None]
        x = y.to(norm.compute_dtype)
    return unit.merge(x, g), mean


def _conv(conv, x, padding):
    """`conv` (layers.Conv2d: input and weight cast to its compute dtype) at
    another padding."""
    dt = conv.compute_dtype
    return F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride, padding)


def _encode(block, x, height: int, g, sh: _Shards):
    """EncodingBlock / ConvFeatureBlock on the rank's rows of an input
    `height` rows tall; replicated (the block's own forward on the gathered
    input) where its output does not split."""
    k, s, p = block.conv_geometry
    if not sh.split(height // s):
        return block(sh.whole(x, height), g)
    if block.use_activation:
        x = F.leaky_relu(x, 0.2)
    u = block.conv
    x = _conv(u.conv, halo_rows(x, p, k - s - p, sh.group), (0, p))
    return _norm_merge(u, x, height // s, g, sh)


def _dropout(drop, x, height: int, sh: _Shards):
    """nn.Dropout on the rank's rows: the mask of the whole map, drawn as
    the single device draws it (F.dropout of ones: 0 or 1 / (1 - p)), cut
    to the rows."""
    if drop is None or not drop.training or drop.p == 0.0:
        return x
    b, c, _, w = x.shape
    mask = F.dropout(torch.ones((b, c, height, w), dtype=x.dtype,
                                device=x.device), drop.p, True)
    return x * sh.mine(mask, height)


def _decode(block, x, skip, height: int, g, sh: _Shards):
    """DecodingBlock on the rank's rows of an input `height` rows tall
    (output 2 * height); replicated where the input does not split, its
    output then cut to the rank's rows where that splits."""
    if not sh.split(height):
        out, mean = block(x, skip, g)
        return sh.mine(out, 2 * height), mean
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    x = F.leaky_relu(x, 0.2)
    u = block.deconv
    # Upsampled rows 2 lo - 1 .. 2 (lo + rows) + 1: one above and two below
    # the rank's, what the first conv reads of the row-padded upsample.
    x = L.upsample_nearest_2x(halo_rows(x, 1, 1, sh.group))[:, :, 1:]
    x = u.conv[2](F.pad(x, (1, 2)))
    x = u.conv[4](F.pad(halo_rows(x, 1, 2, sh.group), (1, 2)))
    x, mean = _norm_merge(u, x, 2 * height, g, sh)
    return _dropout(block.dropout, x, 2 * height, sh), mean


def _append_coords(x, height: int, sh: _Shards):
    """layers.append_coords on the rank's rows: its rows of the global y
    coordinates."""
    b, _, rows, w = x.shape
    xs = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    ys = sh.mine(-torch.linspace(-1.0, 1.0, height, dtype=x.dtype,
                                 device=x.device), height, dim=0)
    coords = torch.stack([xs[None, :].expand(rows, w),
                          ys[:, None].expand(rows, w)])
    return torch.cat([x, coords[None].expand(b, 2, rows, w)], dim=1)


def _generator(gen, x, height: int, sh: _Shards):
    """Generator.forward on the rank's rows (B, C, height / N, W)."""
    d = gen.depth
    if gen.use_coords:
        x = _append_coords(x, height, sh)
    x = x.to(gen.compute_dtype)
    g = gen.gte1(_mean_and_sums(x, height, sh, False)[0], None)
    h, _ = _encode(gen.enc1, x, height, None, sh)
    height //= 2
    skips = [h]
    for i in range(1, d):
        h, mean = _encode(getattr(gen, f"enc{i + 1}"), h, height, g, sh)
        height //= 2
        skips.append(h)
        g = getattr(gen, f"gte{i + 1}")(mean, g)
    for i in range(d):
        skip = None if i == 0 else skips[d - 1 - i]
        h, mean = _decode(getattr(gen, f"dec{d - i}"), h, skip, height, g,
                          sh)
        height *= 2
        g = getattr(gen, f"gtd{d - i}")(mean, g)
    return h, g


def _height_of(images: torch.Tensor, group) -> int:
    """The global height of the rank's rows (B, [N,] H / world, W, 3),
    which must split."""
    height = images.shape[-3] * _world(group)
    if not splits(height, group):
        raise ValueError(f"{height} rows do not split over "
                         f"{_world(group)} ranks")
    return height


def spatial_forward(model, image_rows: torch.Tensor, group) -> torch.Tensor:
    """The model's forward on the rank's rows of the images, (B, [N,] H /
    world, W, 3) -> the rank's rows of the maps (B, H / world, W, 12), f32:
    the sharded walk over the single- or multi-view model's own modules."""
    sh = _Shards(group)
    height = _height_of(image_rows, group)
    if isinstance(model, MultiViewModel):
        images = image_rows if image_rows.dim() == 5 else image_rows[:, None]
        b, n, rows, w, _ = images.shape
        spatial, global_vec = _generator(
            model.generator, images.reshape(b * n, rows, w, 3).permute(
                0, 3, 1, 2), height, sh)
        spatial = torch.amax(spatial.reshape(b, n, *spatial.shape[1:]),
                             dim=1)
        g_pooled = torch.amax(global_vec.reshape(b, n, -1), dim=1)
        x = model.merge(spatial, g_pooled)
        g = model.gt1(_mean_and_sums(spatial, height, sh, False)[0],
                      g_pooled)
        x, mean = _encode(model.conv1, x, height, g, sh)
        g = model.gt2(mean, g)
        x, mean = _encode(model.conv2, x, height, g, sh)
        g = model.gt3(mean, g)
        x, _ = _encode(model.conv3, x, height, g, sh)
        return head_to_svbrdf(x.permute(0, 2, 3, 1))
    images = image_rows[:, 0] if image_rows.dim() == 5 else image_rows
    sv9, _ = _generator(model.generator, images.permute(0, 3, 1, 2), height,
                        sh)
    return head_to_svbrdf(sv9.permute(0, 2, 3, 1))


def batch_rows(batch: dict, group) -> dict:
    """This rank's rows of H of a prepared batch: the maps (B, H, W, 12)
    and the photos (B, N, H, W, 3)."""
    return {k: take_rows(v, group, v.dim() - 3) for k, v in batch.items()}


def _svbrdf_l1_share(pred, target, world: int) -> torch.Tensor:
    """The rank's share of losses.svbrdf_l1_loss: each map's sum over the
    rank's rows over the whole batch's element count, which is the mean
    over the rows (1 / world of the elements) over world, in f32."""
    return losses.svbrdf_l1_loss(pred.float(), target.float()) / world


def spatial_rendering_loss(pred: torch.Tensor, target: torch.Tensor, group,
                           generator: Optional[torch.Generator] = None,
                           scenes=None) -> torch.Tensor:
    """This rank's share of the rendering loss of (B, H, W, 12) maps of
    which it holds rows rank * H/N .. (rank + 1) * H/N - 1 (pred and target
    NHWC): the fused rendering-only loss (render_fused, the CUDA kernels
    render_fwdgrad / render_fwd on the card) of its rows at row offset
    rank * H/N and global height H, so that the shares sum to the whole
    image's loss. The scenes (3 random + 6 specular per item) are drawn
    from `generator` for the whole batch unless given, the same on every
    rank. The rank backpropagates its share; the loss is the sum of the
    shares (shard_total)."""
    rows = pred.shape[1]
    if scenes is None:
        scenes = sampling.generate_loss_scenes(
            pred.shape[0], losses.N_RANDOM_SCENES, losses.N_SPECULAR_SCENES,
            generator=generator, device=pred.device)
    return render_fused.rendering_loss_fused_planes(
        losses.to_planes(pred), losses.to_planes(target.to(pred.dtype)),
        scenes, row_offset=_rank(group) * rows,
        global_height=rows * _world(group))


def make_spatial_loss_fn(kind: str, group, l1_weight: float = 0.1):
    """loss_fn(pred_rows, target_rows, generator=None, scenes=None) -> this
    rank's share of the loss, as the JAX spatial step forms it: "mixed"
    l1_weight * svbrdf_l1_loss + spatial_rendering_loss, the L1 term as the
    shard's sums over the whole batch's counts; "rendering" the rendering
    loss alone. Its `draws` are a make_loss_fn loss's (the scenes), so
    step.loss_rows draws for it."""
    if kind not in ("mixed", "rendering"):
        raise ValueError(f"spatial sharding needs a rendering-based loss, "
                         f"got {kind!r}")
    weight = l1_weight if kind == "mixed" else 0.0
    world = _world(group)

    def spatial_loss(pred, target, generator=None, scenes=None):
        loss = spatial_rendering_loss(pred, target, group, generator, scenes)
        if weight:
            loss = weight * _svbrdf_l1_share(pred, target, world) + loss
        return loss

    spatial_loss.draws = ("scenes",)
    return spatial_loss


def shard_total(share: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's share of a loss, f32, on every rank (not
    differentiable)."""
    total = share.detach().float().reshape(1).clone()
    if _world(group) > 1:
        dist.all_reduce(total)
    return total[0]


def align_default_generators(device, group) -> None:
    """Give every rank rank 0's state of torch's default generators (the
    CPU's and `device`'s), which draw the dropout masks: then every rank
    draws the masks of the whole map that one device would."""
    if _world(group) == 1:
        return
    dev = torch.device(device)
    states = [torch.get_rng_state()]
    if dev.type == "cuda":
        states.append(torch.cuda.get_rng_state(dev))
    mesh.replicate_tree(states, group)
    torch.set_rng_state(states[0])
    if dev.type == "cuda":
        torch.cuda.set_rng_state(states[1], dev)


class SpatialTrainStep(TrainStep):
    """TrainStep with the image height split over a group
    (parallel/mesh.DataGroup; None runs it at world 1): the counterpart of
    the JAX package's make_spatial_train_step (:128-169), with TrainStep's
    interface.

    Every rank prepares the whole batch from the same raw batch and the
    same generator, through the one draw path (step.prepare_rows, the whole
    batch as the span), as the JAX loop prepares replicated and then
    reshards, and keeps its rows of H (batch_rows). The forward is the
    sharded walk (spatial_forward; f32 maps, as the JAX step's model
    output); the loss is the rank's share (make_spatial_loss_fn, drawn for
    the whole batch by step.loss_rows), and each rank backpropagates its
    own share: a backward of the summed loss on every rank would make every
    gradient N times too large. Then the parameter gradients and the loss
    are summed over the group (reduce_gradients, scale 1), and every rank
    applies the same update with the same master salt, so the replicas stay
    bit-identical.

    At construction the weights, buffers and optimizer state are broadcast
    from rank 0 and so is the state of the default generators (dropout's
    masks). update(batch) takes the whole prepared batch; update() and
    __call__ return the group's loss."""

    def __init__(self, model, optimizer, loss_fn: Callable, prep: PrepConfig,
                 generator: torch.Generator, group, seed: int = 0):
        super().__init__(model, optimizer, loss_fn, prep, generator, seed)
        self.space = group
        self.params = list(model.parameters())
        if _world(group) > 1:
            replicate_training_state(model, optimizer, group)
        align_default_generators(self.params[0].device, group)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return spatial_forward(self.model, inputs.to(self.dtype), self.space)

    def reduce(self, loss: torch.Tensor) -> torch.Tensor:
        if _world(self.space) == 1:
            return loss.detach()
        return reduce_gradients(self.params, loss, self.space, scale=1.0)

    def update(self, batch: dict, scenes=None, step: Optional[int] = None,
               samples=None, span: Optional[tuple] = None) -> torch.Tensor:
        """A step on the whole prepared batch (this rank keeps its rows);
        `scenes` are the whole batch's."""
        span = span or _span(batch["svbrdf"].shape[0])
        return super().update(batch_rows(batch, self.space), scenes, step,
                              samples, span)


def make_spatial_eval_step(model, loss_fn: Callable, prep: PrepConfig,
                           generator: torch.Generator, group):
    """Validation step of the spatial group: eval(raw_batch, scenes=None)
    -> the group's loss with dropout off, value only (under no_grad the
    value-only kernel render_fwd runs), drawn as SpatialTrainStep draws;
    every rank takes part and returns the total."""
    dt = compute_dtype(model)

    def eval_step(raw_batch: dict, scenes=None) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            batch, span = prepare_rows(raw_batch, prep, generator)
            rows = batch_rows(batch, group)
            pred = spatial_forward(model, rows["inputs"].to(dt), group)
            share = loss_rows(loss_fn, pred, rows["svbrdf"], generator, span,
                              scenes)
            return shard_total(share, group)

    return eval_step


def make_spatial_predict_fn(model, group):
    """Sharded inference: images (B, [N,] H, W, 3), the whole images on
    every rank -> this rank's rows of the (B, H, W, 12) maps, f32, dropout
    off (gather_maps puts the rows together on rank 0)."""

    def predict(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            return spatial_forward(
                model, take_rows(images, group, images.dim() - 3), group)

    return predict


def gather_maps(rows: torch.Tensor, group) -> Optional[torch.Tensor]:
    """Every rank's rows (B, H / N, W, C) put together: the whole maps on
    rank 0, None on the others (every rank must call it)."""
    with torch.no_grad():
        whole = gather_rows(rows, group, dim=1)
    return whole if _rank(group) == 0 else None
