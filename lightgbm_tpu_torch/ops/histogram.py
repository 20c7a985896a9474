"""Histograms and split routing of the growers: kernels K1, K2, K3, K5, K6
and K7, their plain PyTorch versions, and the host-side helpers.

Counterpart of lightgbm_tpu/ops/pallas_histogram.py.  The TPU kernels
there become hand-written CUDA kernels in ``csrc/histogram.cu``:

  * ``histogram_segment`` (K1): per-(feature, bin) sums of gradient,
    hessian and count over the rows of one leaf inside its confinement
    window (whole row blocks ``[start_block, start_block + n_blocks)``);
  * ``route_window`` (K2): one split's leaf-id update over the parent's
    window;
  * ``histogram_segment_routed`` (K3): K2 then K1 on the updated ids, in
    one pass; with ``null_route()`` it is K1;
  * ``histogram_segment_step``, ``route_window_step`` and
    ``histogram_segment_routed_step``: K1, K2 and K3 with their window,
    target and route read from a step block in device memory
    (``pack_step``: [start_block, n_blocks, target, route]), as the TPU
    kernels read their scalar-prefetch operand; the segment grower's
    split step builds the block on the device (``pack_route_device``), so
    the host reads no value of a split;
  * ``histogram_all`` (K5): the histogram of every row for each of C
    stacked channel sets (``pack_channel_sets``) — the C class-tree roots
    of a multiclass iteration in one launch;
  * ``histogram_frontier`` (K6): the histograms of KT target leaves in
    one pass over a list of whole row blocks (``union_block_list``: the
    union of the frontier round's confinement windows) -> [KT, F, B, 3];
  * ``histogram_frontier_routed`` / ``histogram_frontier_fusedk`` (K7):
    the round's K split routes applied to ``leaf_id`` over the listed
    blocks, then K6 from the updated ids, for KT = K (the smaller
    children) or KT = 2K targets (both children of every split).

Each wrapper takes tensors on one device.  A CPU tensor goes to the plain
version (``*_plain``, bincount and where), which is also what the card
run compares each kernel with; a CUDA tensor goes to the kernel, or the
wrapper raises.  The kernels update ``leaf_id`` in place (the TPU kernels
aliased it as an input/output), and so do the plain versions.

Every call of a card kernel is one kernel launch and nothing else on
the stream, so it can be captured in a CUDA graph: K2's and K3's route
and K6/K7's targets and routes travel in the launch's parameters
(``frontier_params``) or, for the step entries, in a device tensor, and
the histogram kernels sum into a per-device scratch that every launch
leaves zero (``_kernel_scratch``).

The weight stream is ``pack_channels``'s [8, Npad] bf16 layout
``[g_hi, g_lo, h_hi, h_lo, member, 0, 0, 0]``; the kernels read the five
live channels.  A histogram is ``[F, B, 3]`` f32 (sum_grad, sum_hess,
count) over the F rows of the bin matrix, its columns: EFB groups on a
bundled dataset (core/bundle.py), where a route names its feature's
column and bin offset and the scan expands the group histogram.  The
card kernels sum in 64-bit fixed point, so their sums do not depend on
the order of the rows; ``fixed_point_scales`` picks the scale
(``class_scales``: one pair per channel set, each as for that set alone).

``packed4`` (every wrapper takes it): the bin matrix holds two <= 16-bin
columns a byte (``pack_bins_4bit``: column 2i in the low nibble of byte
row i, 2i + 1 in the high one), [ceil(G / 2), Npad], the JAX package's
layout for a dataset whose bin axis is at most 16.  The kernels read each
byte and pick the nibble; the plain versions unpack the rows they read
(``unpack_bins_4bit``) and run as unpacked.  The histograms then have 2 x
the byte rows columns, the zero pad nibble of an odd G included (the JAX
kernels' F_log), which the growers drop before the scan; a route's row
word is the byte row (``pack_route``), its column word picks the nibble.

The packed-accumulator stream (JAX's ``LIGHTGBM_TPU_PACKED_ACC``
branch, pallas_histogram.py:172-258).  In place of ``w8`` every histogram
wrapper (K1, K3, their step entries, K5 with one set, K6, K7) takes the
[2, Npad] int32 stream of ``quantize_pack`` (kernel Q1, csrc/quantize.cu),
told apart by its dtype as the JAX wrappers do, with the quantizer's
``scales`` in place of fixed_point_scales: row 0 packs each row's
stochastically rounded gradient and hessian as two int16 halves, row 1
holds member as f32 bits.  The kernels add the halves as 32-bit integers
(bf16-rounded above 9 bits, as the TPU's matrix unit adds them) and write
``float(sum) * scale``; the plain versions sum the same integers in
float64 and dequantize in the same order (``unpack_hist_packed``), so a
sum below 2^24 is, bit for bit, the JAX kernels' f32 sum.  Such a launch
counts under ``kernels.variant(name, packed4, True)``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.grower import routed_left
from ..utils import random
from . import kernels

NUM_CHANNELS = 8
# quantize_pack's key seed (pallas_histogram.py:217)
_QUANT_KEY_SEED = 0x517CC1B7
_MASK32 = 0xFFFFFFFF
# pack_route's layout: leaf, new_leaf, row, col, thr, dl, cat, mt, dbin,
# nbf, off + 8 bitset words
ROUTE_WORDS = 19
# pack_step's layout: start_block, n_blocks, target, then a route
STEP_WORDS = 3 + ROUTE_WORDS
# the best-split cache's int32 row, which pack_route_device reads: feature,
# threshold, default_left, is_cat, then the categorical bitset as 8 int32
# words (the 32-bit words pack_route views as int32)
SPLIT_WORDS = 12
# frontier_width's constants, as lightgbm_tpu/ops/pallas_histogram.py has
# them (_FRONTIER_K and its 6 MB accumulator budget)
_FRONTIER_K = 16
_FRONTIER_ACC_BYTES = 6 * 1024 * 1024
# K6/K7's parameter block (csrc/histogram.cu FrontierParams): a head of
# [n_targets, n_routes, n_ids, 0], then room for this many targets and
# routes, every frontier the grower asks at num_leaves <= 257
FRONTIER_MAX_ROUTES = 256
FRONTIER_MAX_TARGETS = 512
_PARAM_HEAD = 4


def pack_channels(grad: torch.Tensor, hess: torch.Tensor,
                  member: torch.Tensor) -> torch.Tensor:
    """[N] f32 grad/hess/member -> [8, N] bf16 weight channels.  hi is
    the round-to-nearest-even bf16 of the value, lo the bf16 of what is
    left, so hi + lo carries ~16 mantissa bits."""
    gm = grad * member
    hm = hess * member
    g_hi = gm.to(torch.bfloat16)
    h_hi = hm.to(torch.bfloat16)
    g_lo = (gm - g_hi.float()).to(torch.bfloat16)
    h_lo = (hm - h_hi.float()).to(torch.bfloat16)
    z = torch.zeros_like(g_hi)
    return torch.stack([g_hi, g_lo, h_hi, h_lo, member.to(torch.bfloat16),
                        z, z, z])


def pack_channel_sets(grads: torch.Tensor, hess: torch.Tensor,
                      member: torch.Tensor) -> torch.Tensor:
    """[C, N] grad/hess and [N] member -> [8C, N] bf16: C stacked
    pack_channels sets, class c's at rows [8c, 8c + 8)."""
    return torch.cat([pack_channels(grads[c], hess[c], member)
                      for c in range(grads.shape[0])])


def unpack_hist(out: torch.Tensor) -> torch.Tensor:
    """[..., 8] channel sums -> [..., 3] (sum_grad, sum_hess, count)."""
    return torch.stack([out[..., 0] + out[..., 1],
                        out[..., 2] + out[..., 3], out[..., 4]], dim=-1)


def fixed_point_scales(w8: torch.Tensor) -> torch.Tensor:
    """[2] f32 powers of two (gradient, hessian) for the card kernels'
    64-bit fixed-point sums: the largest scale at which the whole array's
    absolute sum stays below 2^62, so no leaf's sum can overflow.  At the
    HIGGS shape the quantum is ~2^-39 for gradients of magnitude <= 1,
    finer than the bf16 lo channel, so the sums are exact in practice."""
    n = max(int(w8.shape[1]), 1)
    mags = torch.stack([(w8[0].float().abs() + w8[1].float().abs()).max(),
                        (w8[2].float().abs() + w8[3].float().abs()).max()])
    mags = torch.clamp(mags.double() * n, min=1e-30)
    exps = torch.clamp(61.0 - torch.ceil(torch.log2(mags)), -126.0, 126.0)
    return torch.exp2(exps).float()


def check_packed_acc_bits(bits: int) -> int:
    """``bits`` of the packed accumulator as an int in [2, 15], or raise
    (the JAX package clamps LIGHTGBM_TPU_PACKED_BITS into that range,
    pallas_histogram.py:172-186; the port takes a number and refuses one
    outside it)."""
    if isinstance(bits, bool) or int(bits) != bits or not 2 <= bits <= 15:
        raise ValueError(f"packed_acc_bits must be an integer in [2, 15], "
                         f"got {bits!r}")
    return int(bits)


def quantize_inputs(grad: torch.Tensor, hess: torch.Tensor,
                    member: torch.Tensor, bits: int):
    """The quantizer's scales and seed, by torch reductions on the
    tensors' device (no value on the host): ``(scales [2] f32, seed [1]
    int64)``, the plain path's (Q1 on a card computes them in its first
    kernel).  scales = max(max |x * member|, 1e-30) / qmax for the
    gradient and the hessian, an IEEE f32 division on every device (a
    tensor divisor: ATen on a card multiplies by the reciprocal of a
    Python number, which can differ by an ulp); seed the uint32 sum of
    the bits of (grad * member)[:8] (pallas_histogram.py:206-216)."""
    qmax = float(2 ** (bits - 1) - 1)
    gm = grad * member
    hm = hess * member
    mags = torch.stack([gm.abs().max(), hm.abs().max()])
    scales = torch.clamp(mags, min=1e-30) / torch.full_like(mags, qmax)
    bits8 = gm[:8].contiguous().view(torch.int32).to(torch.int64) & _MASK32
    return scales, (bits8.sum() & _MASK32).reshape(1)


def quantize_pack_plain(grad: torch.Tensor, hess: torch.Tensor,
                        member: torch.Tensor, scales: torch.Tensor,
                        seed: torch.Tensor, bits: int):
    """Plain Q1 -> ``(w2 [2, N] int32, clips int32 [1])``: the stochastic
    rounding of grad * member and hess * member at ``scales``, with the
    uniforms of the keys split(fold_in(PRNGKey(0x517CC1B7), seed)), packed
    as pallas_histogram.py:quantize_pack_channels packs them (:218-233)."""
    n = grad.shape[0]
    qmax = float(2 ** (bits - 1) - 1)
    key = random.fold_in(random.prng_key(_QUANT_KEY_SEED, grad.device),
                         seed[0])
    keys = random.split(key)

    def q(x, scale, k):
        t = x / scale
        fl = torch.floor(t)
        up = random.uniform(k, n) < (t - fl)
        return torch.clamp(fl + up.to(torch.float32), -qmax,
                           qmax).to(torch.int64)

    gq = q(grad * member, scales[0], keys[0])
    hq = q(hess * member, scales[1], keys[1])
    clips = ((gq.abs() >= qmax).sum() + (hq.abs() >= qmax).sum()).to(
        torch.int32).reshape(1)
    word = (gq * 65536 + (hq & 0xFFFF)) & _MASK32
    word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    member_bits = member.to(torch.float32).contiguous().view(torch.int32)
    return torch.stack([word, member_bits]), clips


def quantize_pack(grad: torch.Tensor, hess: torch.Tensor,
                  member: torch.Tensor, bits: int = 8):
    """Q1: [N] f32 grad/hess/member -> ``(w2 [2, N] int32, scales [2] f32,
    clips int32 [])``, the packed-accumulator stream for the histogram
    kernels, bit for bit the JAX package's quantize_pack_channels(grad,
    hess, member, bits=bits) on the same inputs.  Pad and out-of-bag rows
    (member 0) quantize to zero.  ``clips`` counts the values quantized to
    +-qmax (the JAX growers' quant_clips).  On a card: two kernel launches
    (the scales, seed and keys, then the stream) and no other operation;
    ``scales`` and ``clips`` are views of one parameter block the kernels
    write, and nothing is read on the host."""
    bits = check_packed_acc_bits(bits)
    if _device_kind(grad) == "cpu":
        scales, seed = quantize_inputs(grad, hess, member, bits)
        w2, clips = quantize_pack_plain(grad, hess, member, scales, seed,
                                        bits)
        return w2, scales, clips.reshape(())
    dev = grad.device
    n = grad.shape[0]
    _check_cuda(dev, grad=(grad, torch.float32), hess=(hess, torch.float32),
                member=(member, torch.float32))
    if grad.dim() != 1 or hess.shape != (n,) or member.shape != (n,) \
            or n == 0:
        raise ValueError("grad, hess and member must be [N], N > 0")
    w2 = torch.empty((2, n), dtype=torch.int32, device=dev)
    params = torch.empty(8, dtype=torch.int32, device=dev)
    rc = kernels.library().lgbt_quantize_pack(
        grad.data_ptr(), hess.data_ptr(), member.data_ptr(), n, bits,
        _quant_scratch(dev).data_ptr(), params.data_ptr(), w2.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check_launch("quantize_pack", rc)
    return w2, params[:2].view(torch.float32), params[6]


# Q1's persistent scratch a device (csrc/quantize.cu: two maxima and an
# arrival counter), zeroed once; each call leaves it zero
_QUANT_SCRATCH = {}


def _quant_scratch(device: torch.device) -> torch.Tensor:
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    if key not in _QUANT_SCRATCH:
        _QUANT_SCRATCH[key] = torch.zeros(4, dtype=torch.int32,
                                          device=device)
    return _QUANT_SCRATCH[key]


def unpack_hist_packed(out: torch.Tensor, scales: torch.Tensor
                       ) -> torch.Tensor:
    """[..., C >= 3] packed-accumulator sums (g_q, h_q, count, ...) ->
    [..., 3] real units (sum_grad, sum_hess, count): the integer sums
    times the quantizer's scales in f32 (pallas_histogram.py:236-242)."""
    return torch.stack([out[..., 0] * scales[0], out[..., 1] * scales[1],
                        out[..., 2]], dim=-1)


def acc_values(q: torch.Tensor) -> torch.Tensor:
    """Quantized values as the packed-accumulator kernels add them: i32 ->
    f32 -> bf16 (round to nearest even) -> float64, the identity up to 9
    bits (_packed_wrows, pallas_histogram.py:255-256)."""
    return q.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def packed_weight_channels(w2: torch.Tensor, cols) -> torch.Tensor:
    """[2, N] int32 packed-accumulator stream -> [3, rows] float64 ``[g_q,
    h_q, member]`` at the columns ``cols``, the JAX kernels' widened
    channels without their zero one: the int16 halves sign-extended and
    bf16-rounded (acc_values), member from its f32 bits (_packed_wrows,
    pallas_histogram.py:245-258)."""
    w = w2[0, cols].to(torch.int64)
    g = acc_values(w >> 16)
    h = acc_values(((w & 0xFFFF) ^ 0x8000) - 0x8000)
    m = w2[1, cols].contiguous().view(torch.float32).to(torch.float64)
    return torch.stack([g, h, m])


def _weight_channels(w: torch.Tensor, cols) -> torch.Tensor:
    """The five channels _plain_sums adds, float64 [5, rows] at the
    columns ``cols``: w8's [g_hi, g_lo, h_hi, h_lo, member], or a packed
    stream's [g_q, 0, h_q, 0, member], whose sums unpack_hist then leaves
    as the integer sums."""
    if w.dtype != torch.int32:
        return w[:5, cols].double()
    g, h, m = packed_weight_channels(w, cols)
    z = torch.zeros_like(m)
    return torch.stack([g, z, h, z, m])


def _finish(hist: torch.Tensor, w: torch.Tensor, scales) -> torch.Tensor:
    """A plain histogram in real units: as it is, or (a packed stream)
    its integer sums times ``scales`` (unpack_hist_packed)."""
    if w.dtype != torch.int32:
        return hist
    if scales is None:
        raise ValueError("a packed-accumulator stream needs its scales "
                         "(quantize_pack)")
    return unpack_hist_packed(hist, scales.to(hist.device))


def class_scales(w8C: torch.Tensor) -> torch.Tensor:
    """[C, 2] f32: fixed_point_scales of each 8-channel set of ``w8C``, so
    class c's sums use the scale its tree's own kernels use."""
    return torch.stack([fixed_point_scales(w8C[8 * c:8 * c + 8])
                        for c in range(w8C.shape[0] // NUM_CHANNELS)])


def pack_bins_4bit(binsT: np.ndarray) -> np.ndarray:
    """[G, N] u8 (bins <= 15) -> [ceil(G / 2), N] u8, column 2i in the low
    nibble of byte row i and 2i + 1 in the high one, a zero high nibble
    for an odd G: byte for byte lightgbm_tpu/ops/pallas_histogram.py
    pack_bins_4bit (the reference's Dense4bitsBin, dense_nbits_bin.hpp:42,
    cut for a column-major stream)."""
    binsT = np.asarray(binsT)
    if binsT.shape[0] % 2:
        binsT = np.concatenate(
            [binsT, np.zeros((1, binsT.shape[1]), binsT.dtype)])
    return (binsT[0::2] | (binsT[1::2] << 4)).astype(np.uint8)


def unpack_nibble(byte: torch.Tensor, col) -> torch.Tensor:
    """Column ``col``'s bins (int32) out of the bytes that hold it: the
    high nibble for an odd column, the low one for an even column (the
    inverse of pack_bins_4bit; ``col`` an int or a tensor)."""
    b = byte.to(torch.int32)
    return torch.where(torch.as_tensor(col) % 2 == 1, b >> 4, b & 15)


def unpack_bins_4bit(packed: torch.Tensor) -> torch.Tensor:
    """[P, ...] packed bytes -> [2P, ...] u8, one column a row (the pad
    nibble of an odd G last)."""
    b = packed.to(torch.uint8)
    return torch.stack([b & 15, b >> 4], dim=1).reshape(
        (2 * b.shape[0],) + tuple(b.shape[1:]))


def slice_packed_column(binsT: torch.Tensor, col: int) -> torch.Tensor:
    """One column [N] int32 of a packed [P, N] bin matrix."""
    return unpack_nibble(binsT[int(col) // 2], int(col))


def logical_columns(binsT: torch.Tensor, packed4: bool) -> int:
    """The histogram's columns over a bin matrix: its rows, or 2 x its
    byte rows packed."""
    return 2 * binsT.shape[0] if packed4 else binsT.shape[0]


def pack_route(leaf: int, new_leaf: int, f: int, t: int, dl: bool,
               cat: bool, bitset, fmeta,
               packed4: bool = False) -> torch.Tensor:
    """[ROUTE_WORDS] int32 route descriptor, on the host (the kernels take
    it as launch arguments), word for word the JAX package's
    ``pack_route(..., packed4)`` (pallas_histogram.py:979-998).
    ``fmeta`` is a FeatureMeta whose fields can be indexed on the host.
    The group column is the feature's EFB column (``feat_group[f]``; the
    feature itself without EFB), the bin row that column, or its byte row
    ``col // 2`` packed, and ``off`` its bin offset there, which the
    kernels undo (goes_right)."""
    bundled = fmeta.feat_group is not None
    col = int(fmeta.feat_group[f]) if bundled else int(f)
    off = int(fmeta.feat_offset[f]) if bundled else 0
    row = col // 2 if packed4 else col
    head = [int(leaf), int(new_leaf), row, col, int(t), int(bool(dl)),
            int(bool(cat)), int(fmeta.missing_type[f]),
            int(fmeta.default_bin[f]), int(fmeta.num_bin[f]), off]
    words = np.asarray(bitset, dtype=np.uint32).reshape(8).view(np.int32)
    return torch.tensor(head + words.tolist(), dtype=torch.int32)


def pack_route_device(leaf: torch.Tensor, new_leaf: torch.Tensor,
                      split: torch.Tensor, fmeta,
                      packed4: bool = False) -> torch.Tensor:
    """pack_route on the device: [ROUTE_WORDS] int32 on ``split``'s
    device, equal to pack_route's words for the same split (``packed4``:
    the byte row ``col >> 1``), built without
    reading a value on the host (the EFB tables are gathered on the
    device, so a CUDA graph can hold it).  ``leaf`` and ``new_leaf`` are
    [1] integer tensors; ``split`` is a best-split cache row, int32
    [SPLIT_WORDS]; ``fmeta`` a FeatureMeta of tensors on the same device.
    A feature of -1 (no split) reads feature 0's metadata, so the words
    stay a valid route (the caller gives such a route the leaf -1, which
    no row matches)."""
    f = split[:1].clamp(min=0)
    cols = [fmeta.missing_type, fmeta.default_bin, fmeta.num_bin]
    if fmeta.feat_group is not None:
        cols += [fmeta.feat_group, fmeta.feat_offset]
    meta = torch.stack(cols, dim=1).index_select(0, f.long())[0].to(
        torch.int32)
    col, off = (meta[3:4], meta[4:5]) if fmeta.feat_group is not None \
        else (f, torch.zeros_like(f))
    row = col >> 1 if packed4 else col
    return torch.cat([leaf.to(torch.int32), new_leaf.to(torch.int32), row,
                      col, split[1:4], meta[:3], off,
                      split[4:SPLIT_WORDS]])


def pack_step(start_block, n_blocks, target,
              route: torch.Tensor) -> torch.Tensor:
    """[STEP_WORDS] int32 step block on ``route``'s device: the window
    ``[start_block, start_block + n_blocks)`` in row blocks, the target
    leaf, then the route's words.  The first three are ints or [1]
    integer tensors on that device."""
    head = [torch.as_tensor(x, device=route.device).reshape(1).to(
        torch.int32) for x in (start_block, n_blocks, target)]
    return torch.cat(head + [route])


def null_route() -> torch.Tensor:
    """Route that matches nothing (leaf == -1): the root-histogram case."""
    r = torch.zeros(ROUTE_WORDS, dtype=torch.int32)
    r[0] = -1
    return r


def frontier_width(num_features: int, num_bins: int) -> int:
    """Frontier width K of the frontier grower for this shape, verbatim
    from lightgbm_tpu/ops/pallas_histogram.py:frontier_width.  Its budget
    was sized for a TPU's VMEM and has no meaning on this card, but K
    decides which leaves a round splits, so the port keeps it to grow the
    same trees as the JAX package."""
    F4 = -(-num_features // 4) * 4
    k = _FRONTIER_K
    while k > 1 and F4 * num_bins * NUM_CHANNELS * k * 4 > _FRONTIER_ACC_BYTES:
        k //= 2
    return k


def union_block_list(lo, hi, valid):
    """The frontier round's union of the confinement windows
    ``[lo[j], hi[j])`` (in row blocks) of the slots with ``valid[j]``:
    ``(block_list, n)``, a sorted host int32 tensor of the n distinct
    blocks (lightgbm_tpu/models/grower_frontier.py:498-508)."""
    spans = [np.arange(int(a), int(b), dtype=np.int32)
             for a, b, v in zip(lo, hi, valid) if v and int(b) > int(a)]
    blocks = (np.unique(np.concatenate(spans)) if spans
              else np.zeros(0, np.int32))
    return torch.from_numpy(blocks.astype(np.int32)), int(blocks.shape[0])


# ------------------------------------------------------------------ helpers
def _window(npad: int, start_block: int, n_blocks: int,
            block_rows: int):
    if npad % block_rows:
        raise ValueError(f"Npad {npad} is not a multiple of the row block "
                         f"{block_rows}")
    lo = min(max(int(start_block), 0) * block_rows, npad)
    hi = min(lo + max(int(n_blocks), 0) * block_rows, npad)
    return lo, hi


def _check_cuda(device, **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_route(route: torch.Tensor) -> None:
    if (route.device.type != "cpu" or route.dtype != torch.int32
            or route.shape != (ROUTE_WORDS,) or not route.is_contiguous()):
        raise ValueError("route must be a contiguous host int32 tensor of "
                         f"{ROUTE_WORDS} words (pack_route / null_route)")


def _check_frontier_args(targets, routes, targets_per_route: int) -> None:
    """``routes``: None or a host int32 tensor [K, ROUTE_WORDS] (rows of
    pack_route / null_route); ``targets``: a host int32 tensor of leaf ids
    (-1 = an empty slot), ``targets_per_route`` x K of them when there are
    routes."""
    if routes is not None and (
            not isinstance(routes, torch.Tensor)
            or routes.device.type != "cpu" or routes.dtype != torch.int32
            or routes.dim() != 2 or routes.shape[1] != ROUTE_WORDS
            or routes.shape[0] < 1):
        raise ValueError(f"routes must be a host int32 tensor [K, "
                         f"{ROUTE_WORDS}] (pack_route / null_route rows)")
    if (not isinstance(targets, torch.Tensor)
            or targets.device.type != "cpu" or targets.dtype != torch.int32
            or targets.dim() != 1 or targets.shape[0] < 1
            or (routes is not None and targets.shape[0]
                != targets_per_route * routes.shape[0])):
        raise ValueError("targets must be a 1-D host int32 tensor of leaf "
                         f"ids ({targets_per_route} per route)")


def _check_step(step: torch.Tensor, device) -> None:
    if (step.device != device or step.dtype != torch.int32
            or step.shape != (STEP_WORDS,) or not step.is_contiguous()):
        raise ValueError(f"step must be a contiguous int32 tensor of "
                         f"{STEP_WORDS} words on {device} (pack_step)")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# -------------------------------------------------------------- plain twins
def routed_ids_plain(fcol_raw: torch.Tensor, lid: torch.Tensor,
                     route) -> torch.Tensor:
    """Leaf ids after one split from the descriptor ``route`` (list of
    ROUTE_WORDS ints): EFB column reconstruction, then routed_left."""
    r = [int(x) for x in route]
    off, nbf, dbin = r[10], r[9], r[8]
    g = fcol_raw.to(torch.int32)
    fcol = torch.where((g >= off) & (g < off + nbf), g - off,
                       torch.full_like(g, dbin))
    bitset = torch.tensor(np.asarray(r[11:19], dtype=np.int32)
                          .view(np.uint32).astype(np.int64),
                          device=lid.device)
    go_left = routed_left(fcol, r[4], bool(r[5]), bool(r[6]), bitset,
                          r[7], dbin, nbf)
    return torch.where((lid == r[0]) & ~go_left,
                       torch.full_like(lid, r[1]), lid)


def _route_column(binsT, r, rows, packed4: bool) -> torch.Tensor:
    """The split column's bins at ``rows`` (a slice or an index tensor)
    from the route words ``r``: its bin row r[2], and packed the nibble of
    its column r[3]."""
    byte = binsT[r[2], rows]
    return unpack_nibble(byte, r[3]) if packed4 else byte


def route_window_plain(binsT, leaf_id, start_block, n_blocks, route,
                       block_rows, packed4=False):
    """Plain K2: updates ``leaf_id`` in place over the window."""
    lo, hi = _window(leaf_id.shape[0], start_block, n_blocks, block_rows)
    r = route.tolist()
    if hi > lo:
        leaf_id[lo:hi] = routed_ids_plain(
            _route_column(binsT, r, slice(lo, hi), packed4), leaf_id[lo:hi],
            r)
    return leaf_id


def _read_step_plain(step, bin_rows):
    """A step block's window, target and route (host ints), as the
    kernels read it (csrc/histogram.cu read_step): a route whose bin row
    lies outside the bin matrix's ``bin_rows`` rows routes nothing."""
    s = [int(x) for x in step.tolist()]
    route = s[3:]
    if not 0 <= route[2] < bin_rows:
        route[0], route[2] = -1, 0
    return s[0], s[1], s[2], torch.tensor(route, dtype=torch.int32)


def route_window_step_plain(binsT, leaf_id, step, block_rows,
                            packed4=False):
    """Plain K2 from a step block: updates ``leaf_id`` in place."""
    lo, nb, _, route = _read_step_plain(step, binsT.shape[0])
    return route_window_plain(binsT, leaf_id, lo, nb, route, block_rows,
                              packed4)


def histogram_segment_step_plain(binsT, w8, leaf_id, step, num_bins,
                                 block_rows, packed4=False, scales=None):
    """Plain K1 from a step block -> [F, B, 3] float32."""
    lo, nb, target, _ = _read_step_plain(step, binsT.shape[0])
    return histogram_segment_plain(binsT, w8, leaf_id, lo, nb, target,
                                   num_bins, block_rows, packed4, scales)


def histogram_segment_routed_step_plain(binsT, w8, leaf_id, step, num_bins,
                                        block_rows, packed4=False,
                                        scales=None):
    """Plain K3 from a step block -> (leaf_id, [F, B, 3] float32)."""
    lo, nb, target, route = _read_step_plain(step, binsT.shape[0])
    return histogram_segment_routed_plain(binsT, w8, leaf_id, lo, nb,
                                          target, route, num_bins,
                                          block_rows, packed4, scales)


def _plain_sums(bins, w, num_bins, slot=None, n_slots=1, packed4=False):
    """[F, rows] bins (packed4: [F / 2, rows] bytes, unpacked first) and
    [5, rows] float64 channels -> [F, B, 3] float32: the five channel
    sums by bincount in float64 (so the order the rows arrive in moves no
    bit that survives the cast), then unpack_hist.  Bins >= num_bins are
    dropped, as the kernels drop them.  With ``slot`` ([rows] int64, -1 =
    no slot) each row adds to the histogram of its slot: -> [n_slots, F,
    B, 3]."""
    if packed4:
        bins = unpack_bins_4bit(bins)
    F = bins.shape[0]
    cells = F * num_bins
    total = n_slots * cells
    b = bins.long()
    keys = b + torch.arange(F, device=bins.device)[:, None] * num_bins
    keep = b < num_bins
    if slot is not None:
        keys = keys + slot[None, :] * cells
        keep = keep & (slot >= 0)[None, :]
    keys = torch.where(keep, keys, total).reshape(-1)
    sums = torch.stack([torch.bincount(keys, weights=w[c].repeat(F),
                                       minlength=total + 1)[:total]
                        for c in range(5)], dim=-1)
    out = unpack_hist(sums.reshape(n_slots, F, num_bins, 5)).float()
    return out if slot is not None else out[0]


def histogram_segment_plain(binsT, w8, leaf_id, start_block, n_blocks,
                            target, num_bins, block_rows, packed4=False,
                            scales=None):
    """Plain K1 -> [F, B, 3] float32 (``w8`` a packed-accumulator stream:
    dequantized at its ``scales``)."""
    lo, hi = _window(leaf_id.shape[0], start_block, n_blocks, block_rows)
    sel = (leaf_id[lo:hi] == int(target)).to(torch.float64)
    return _finish(_plain_sums(binsT[:, lo:hi],
                               _weight_channels(w8, slice(lo, hi)) * sel,
                               num_bins, packed4=packed4), w8, scales)


def histogram_all_plain(binsT, w8C, num_bins, packed4=False, scales=None):
    """Plain K5 -> [C, F, B, 3] float32; class c's slice is plain K1 of a
    root whose every row is in leaf 0, on set c (same float64 sums).  A
    packed-accumulator stream is one set, dequantized at its ``scales``."""
    if packed4:
        binsT = unpack_bins_4bit(binsT)
    if w8C.dtype == torch.int32:
        return _finish(_plain_sums(binsT, _weight_channels(w8C, slice(None)),
                                   num_bins), w8C, scales)[None]
    return torch.stack([_plain_sums(binsT, w8C[8 * c:8 * c + 5].double(),
                                    num_bins)
                        for c in range(w8C.shape[0] // NUM_CHANNELS)])


def histogram_segment_routed_plain(binsT, w8, leaf_id, start_block,
                                   n_blocks, target, route, num_bins,
                                   block_rows, packed4=False, scales=None):
    """Plain K3: plain K2, then plain K1 on the updated ids."""
    route_window_plain(binsT, leaf_id, start_block, n_blocks, route,
                       block_rows, packed4)
    return leaf_id, histogram_segment_plain(binsT, w8, leaf_id, start_block,
                                            n_blocks, target, num_bins,
                                            block_rows, packed4, scales)


def _union_rows(block_list, n_blocks, block_rows, device):
    blk = block_list[:int(n_blocks)].to(device=device, dtype=torch.int64)
    return (blk[:, None] * block_rows
            + torch.arange(block_rows, device=device)).reshape(-1)


def histogram_frontier_plain(binsT, w8, leaf_id, block_list, n_blocks,
                             targets, num_bins, block_rows, packed4=False,
                             scales=None):
    """Plain K6 -> [KT, F, B, 3] float32: slot k is plain K1 of leaf
    ``targets[k]`` over the listed blocks' rows (the same float64 sums);
    a -1 slot is zeros.  Targets are distinct (the first match wins)."""
    F = logical_columns(binsT, packed4)
    KT = int(targets.shape[0])
    rows = _union_rows(block_list, n_blocks, block_rows, binsT.device)
    if rows.numel() == 0:
        return torch.zeros((KT, F, num_bins, 3), dtype=torch.float32,
                           device=binsT.device)
    lid = leaf_id[rows]
    slot = torch.full(lid.shape, -1, dtype=torch.int64, device=lid.device)
    for k in reversed(range(KT)):
        t = int(targets[k])
        if t >= 0:
            slot = torch.where(lid == t, k, slot)
    return _finish(_plain_sums(binsT[:, rows], _weight_channels(w8, rows),
                               num_bins, slot, KT, packed4), w8, scales)


def histogram_frontier_routed_plain(binsT, w8, leaf_id, block_list,
                                    n_blocks, targets, routes, num_bins,
                                    block_rows, packed4=False, scales=None):
    """Plain K7: each route of ``routes`` [K, 19] applied to ``leaf_id``
    in place over the listed blocks (at most one matches a row, so their
    order does not matter), then plain K6 on the updated ids.  Returns
    ``(leaf_id, [KT, F, B, 3])`` for any KT (K or 2K)."""
    rows = _union_rows(block_list, n_blocks, block_rows, binsT.device)
    if rows.numel():
        lid = leaf_id[rows]
        for r in routes.tolist():
            if r[0] >= 0:
                lid = routed_ids_plain(_route_column(binsT, r, rows, packed4),
                                       lid, r)
        leaf_id[rows] = lid
    return leaf_id, histogram_frontier_plain(
        binsT, w8, leaf_id, block_list, n_blocks, targets, num_bins,
        block_rows, packed4, scales)


# ----------------------------------------------------------------- wrappers
def segment_tiling(num_features: int, num_bins: int,
                   packed4: bool = False, packed_acc: bool = False) -> dict:
    """The card kernel's tiling of K1/K3 at this shape (``num_features``
    the histogram's columns; ``packed4`` cuts them in pairs; ``packed_acc``
    takes the packed-accumulator stream's 12-byte cells): features a block
    holds, its shared memory, and the feature tiles of the grid
    (csrc/histogram.cu lgbt_segment_tiling).  Raises where not even one
    feature fits."""
    ft, smem = _seg_tiling(int(num_features), int(num_bins), bool(packed4),
                           bool(packed_acc))
    return {"tile_features": ft, "smem_bytes": smem,
            "feature_tiles": -(-num_features // ft)}


@functools.lru_cache(maxsize=64)
def _seg_tiling(num_features, num_bins, packed4, packed_acc):
    out = (ctypes.c_int * 2)()
    rc = kernels.library().lgbt_segment_tiling(num_features, num_bins,
                                               int(packed4), int(packed_acc),
                                               ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"{num_bins} bins do not fit the segment kernel's "
                         "shared memory")
    return tuple(out)


def _check_bins(num_bins: int, packed4: bool) -> None:
    top = 16 if packed4 else 256
    if not 1 <= num_bins <= top:
        raise ValueError(f"num_bins must be in [1, {top}]"
                         + (" with packed4" if packed4 else ""))


def _weight_mode(dev, w: torch.Tensor, npad: int) -> bool:
    """Checks a histogram kernel's weight stream on ``dev``: w8, [8, Npad]
    bf16 (False), or a packed-accumulator stream, [2, Npad] int32 (True:
    the kernels' packed_acc mode, chosen by the dtype as the JAX wrappers
    choose it)."""
    acc = w.dtype == torch.int32
    _check_cuda(dev, w8=(w, torch.int32 if acc else torch.bfloat16))
    if w.shape != ((2 if acc else NUM_CHANNELS), npad):
        raise ValueError("the weights must be w8 [8, Npad] bf16 or a "
                         "packed-accumulator stream [2, Npad] int32")
    return acc


def _launch_hist(name, binsT, w8, leaf_id, start_block, n_blocks, target,
                 route, num_bins, block_rows, scales, packed4):
    rows, npad = binsT.shape
    F = logical_columns(binsT, packed4)
    dev = binsT.device
    _check_cuda(dev, binsT=(binsT, torch.uint8),
                leaf_id=(leaf_id, torch.int32), scales=(scales, torch.float32))
    acc = _weight_mode(dev, w8, npad)
    if leaf_id.shape != (npad,):
        raise ValueError("leaf_id must be [Npad]")
    _check_bins(num_bins, packed4)
    if scales.shape != (2,):
        raise ValueError("scales must be [2]")
    route_ptr = None
    if route is not None:
        _check_route(route)
        if not 0 <= int(route[2]) < rows:
            raise ValueError("the route's bin row is outside binsT")
        route_ptr = route.data_ptr()
    tiles = segment_tiling(F, num_bins, packed4, acc)["feature_tiles"]
    lo, hi = _window(npad, start_block, n_blocks, block_rows)
    # the cells' i64 sums, then one u32 arrival counter a tile
    scratch = _kernel_scratch(dev, F * num_bins * 3 + (tiles + 1) // 2)
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    rc = kernels.library().lgbt_histogram_segment(
        binsT.data_ptr(), w8.data_ptr(), leaf_id.data_ptr(), npad, F,
        num_bins, lo, hi, int(target), scales.data_ptr(), route_ptr,
        scratch.data_ptr(), out.data_ptr(), int(packed4), int(acc),
        kernels.stream_ptr(dev))
    kernels.check_launch(kernels.variant(name, packed4, acc), rc)
    return out


def histogram_segment(binsT: torch.Tensor, w8: torch.Tensor,
                      leaf_id: torch.Tensor, start_block: int,
                      n_blocks: int, target: int, num_bins: int,
                      block_rows: int, scales: torch.Tensor,
                      packed4: bool = False) -> torch.Tensor:
    """K1: histogram of leaf ``target`` over its confinement window ->
    [F, B, 3] f32.  ``scales`` is fixed_point_scales(w8) (the plain
    version sums in float64 and does not use it), or with a
    packed-accumulator stream ``w8`` (quantize_pack's [2, Npad] int32) its
    quantizer's scales."""
    if _device_kind(binsT) == "cpu":
        return histogram_segment_plain(binsT, w8, leaf_id, start_block,
                                       n_blocks, target, num_bins,
                                       block_rows, packed4, scales)
    return _launch_hist("histogram_segment", binsT, w8, leaf_id,
                        start_block, n_blocks, target, None, num_bins,
                        block_rows, scales, packed4)


def histogram_segment_routed(binsT: torch.Tensor, w8: torch.Tensor,
                             leaf_id: torch.Tensor, start_block: int,
                             n_blocks: int, target: int,
                             route: torch.Tensor, num_bins: int,
                             block_rows: int, scales: torch.Tensor,
                             packed4: bool = False):
    """K3: apply ``route`` to ``leaf_id`` in place over the window AND
    histogram ``target`` from the updated ids, in one pass.  Returns
    ``(leaf_id, [F, B, 3] hist)``."""
    if _device_kind(binsT) == "cpu":
        return histogram_segment_routed_plain(binsT, w8, leaf_id,
                                              start_block, n_blocks, target,
                                              route, num_bins, block_rows,
                                              packed4, scales)
    hist = _launch_hist("histogram_segment_routed", binsT, w8, leaf_id,
                        start_block, n_blocks, target, route, num_bins,
                        block_rows, scales, packed4)
    return leaf_id, hist


def _launch_hist_step(name, binsT, w8, leaf_id, step, routed, num_bins,
                      block_rows, scales, out, packed4):
    npad = binsT.shape[1]
    F = logical_columns(binsT, packed4)
    dev = binsT.device
    _check_cuda(dev, binsT=(binsT, torch.uint8),
                leaf_id=(leaf_id, torch.int32), scales=(scales, torch.float32))
    acc = _weight_mode(dev, w8, npad)
    _check_step(step, dev)
    if leaf_id.shape != (npad,):
        raise ValueError("leaf_id must be [Npad]")
    _check_bins(num_bins, packed4)
    if scales.shape != (2,):
        raise ValueError("scales must be [2]")
    if block_rows < 1 or npad % block_rows:
        raise ValueError(f"Npad {npad} is not a multiple of the row block "
                         f"{block_rows}")
    if out is None:
        out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    else:
        _check_cuda(dev, out=(out, torch.float32))
        if out.shape != (F, num_bins, 3):
            raise ValueError("out must be [F, num_bins, 3]")
    tiles = segment_tiling(F, num_bins, packed4, acc)["feature_tiles"]
    scratch = _kernel_scratch(dev, F * num_bins * 3 + (tiles + 1) // 2)
    rc = kernels.library().lgbt_histogram_segment_step(
        binsT.data_ptr(), w8.data_ptr(), leaf_id.data_ptr(), npad, F,
        num_bins, int(block_rows), step.data_ptr(), int(routed),
        scales.data_ptr(), scratch.data_ptr(), out.data_ptr(), int(packed4),
        int(acc), kernels.stream_ptr(dev))
    kernels.check_launch(kernels.variant(name, packed4, acc), rc)
    return out


def _into(out, hist):
    return hist if out is None else out.copy_(hist)


def histogram_segment_step(binsT: torch.Tensor, w8: torch.Tensor,
                           leaf_id: torch.Tensor, step: torch.Tensor,
                           num_bins: int, block_rows: int,
                           scales: torch.Tensor, out: torch.Tensor = None,
                           packed4: bool = False) -> torch.Tensor:
    """K1 over the window of ``step`` for its target leaf (a pack_step
    block on binsT's device; the host reads none of it) -> [F, B, 3] f32,
    written into ``out`` when given.  Bit for bit histogram_segment on
    the same window and target."""
    if _device_kind(binsT) == "cpu":
        _check_step(step, binsT.device)
        return _into(out, histogram_segment_step_plain(
            binsT, w8, leaf_id, step, num_bins, block_rows, packed4, scales))
    return _launch_hist_step("histogram_segment_step", binsT, w8, leaf_id,
                             step, False, num_bins, block_rows, scales, out,
                             packed4)


def histogram_segment_routed_step(binsT: torch.Tensor, w8: torch.Tensor,
                                  leaf_id: torch.Tensor, step: torch.Tensor,
                                  num_bins: int, block_rows: int,
                                  scales: torch.Tensor,
                                  out: torch.Tensor = None,
                                  packed4: bool = False):
    """K3 from a step block: its route applied to ``leaf_id`` in place over
    its window AND its target histogrammed from the updated ids, in one
    pass.  Returns ``(leaf_id, [F, B, 3] hist)`` (into ``out`` when
    given); bit for bit histogram_segment_routed on the same block."""
    if _device_kind(binsT) == "cpu":
        _check_step(step, binsT.device)
        _, hist = histogram_segment_routed_step_plain(
            binsT, w8, leaf_id, step, num_bins, block_rows, packed4, scales)
        return leaf_id, _into(out, hist)
    hist = _launch_hist_step("histogram_segment_routed_step", binsT, w8,
                             leaf_id, step, True, num_bins, block_rows,
                             scales, out, packed4)
    return leaf_id, hist


def histogram_all(binsT: torch.Tensor, w8C: torch.Tensor, num_bins: int,
                  scales: torch.Tensor, packed4: bool = False) -> torch.Tensor:
    """K5: the histogram of every row for each of the C channel sets of
    ``w8C`` ([8C, Npad] bf16, pack_channel_sets; pad rows carry member
    0) -> [C, F, B, 3] f32.  ``scales`` is class_scales(w8C) (the plain
    version does not use it).  ``w8C`` may instead be one
    packed-accumulator stream (quantize_pack's [2, Npad] int32, the JAX
    kernel's single-set int32 branch) with its quantizer's ``scales`` [2]:
    -> [1, F, B, 3]."""
    if _device_kind(binsT) == "cpu":
        return histogram_all_plain(binsT, w8C, num_bins, packed4, scales)
    npad = binsT.shape[1]
    F = logical_columns(binsT, packed4)
    dev = binsT.device
    _check_cuda(dev, binsT=(binsT, torch.uint8),
                scales=(scales, torch.float32))
    acc = w8C.dtype == torch.int32
    if acc:
        _weight_mode(dev, w8C, npad)
        C = 1
        if scales.shape != (2,):
            raise ValueError("a packed-accumulator stream's scales are [2]")
    else:
        _check_cuda(dev, w8C=(w8C, torch.bfloat16))
        C = w8C.shape[0] // NUM_CHANNELS
        if (C < 1 or w8C.shape != (NUM_CHANNELS * C, npad)
                or scales.shape != (C, 2)):
            raise ValueError("w8C must be [8C, Npad] and scales [C, 2]")
    _check_bins(num_bins, packed4)
    tiling = all_tiling(F, num_bins, C, packed4, acc)
    tiles = tiling["feature_tiles"] * tiling["set_tiles"]
    # the cells' i64 sums, then one u32 arrival counter a tile
    scratch = _kernel_scratch(dev, C * F * num_bins * 3 + (tiles + 1) // 2)
    out = torch.empty((C, F, num_bins, 3), dtype=torch.float32, device=dev)
    rc = kernels.library().lgbt_histogram_all(
        binsT.data_ptr(), w8C.data_ptr(), npad, F, num_bins, C,
        scales.data_ptr(), scratch.data_ptr(), out.data_ptr(), int(packed4),
        int(acc), kernels.stream_ptr(dev))
    kernels.check_launch(kernels.variant("histogram_all", packed4, acc), rc)
    return out


def leaf_histogram(binsT: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, member: torch.Tensor, num_bins: int,
                   packed4: bool = False, packed_acc: bool = False,
                   bits: int = 8) -> torch.Tensor:
    """One leaf's [F, B, 3] histogram by K5 over every row, ``member``
    selecting the leaf's rows (lightgbm_tpu/ops/pallas_histogram.py
    leaf_histogram_pallas :2273-2290): from pack_channels' fixed-point
    channels, or with ``packed_acc`` from the packed-accumulator stream,
    quantized for this call (quantize_pack at ``bits``), so its scales are
    the leaf's own."""
    if packed_acc:
        w2, scales, _ = quantize_pack(grad, hess, member, bits)
        return histogram_all(binsT, w2, num_bins, scales, packed4)[0]
    w8 = pack_channels(grad, hess, member)
    return histogram_all(binsT, w8, num_bins, class_scales(w8), packed4)[0]


def all_tiling(num_features: int, num_bins: int, num_sets: int,
               packed4: bool = False, packed_acc: bool = False) -> dict:
    """The card kernel's tiling of K5 at this shape (``packed4``: features
    in pairs; ``packed_acc``: 12-byte cells): the features and channel sets
    a block holds, its shared memory, and the feature and set tiles of the
    grid (csrc/histogram.cu lgbt_all_tiling).  Raises where not even one
    feature of one set fits."""
    ft, st, smem = _all_tiling(int(num_features), int(num_bins),
                               int(num_sets), bool(packed4), bool(packed_acc))
    return {"tile_features": ft, "tile_sets": st, "smem_bytes": smem,
            "feature_tiles": -(-num_features // ft),
            "set_tiles": -(-num_sets // st)}


@functools.lru_cache(maxsize=64)
def _all_tiling(num_features, num_bins, num_sets, packed4, packed_acc):
    out = (ctypes.c_int * 3)()
    rc = kernels.library().lgbt_all_tiling(num_features, num_bins, num_sets,
                                           int(packed4), int(packed_acc),
                                           ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"{num_bins} bins do not fit the kernel's tile")
    return tuple(out)


def route_window(binsT: torch.Tensor, leaf_id: torch.Tensor,
                 start_block: int, n_blocks: int, route: torch.Tensor,
                 block_rows: int, packed4: bool = False) -> torch.Tensor:
    """K2: apply one split's route to ``leaf_id`` in place over the
    parent's window; returns ``leaf_id``."""
    if _device_kind(binsT) == "cpu":
        return route_window_plain(binsT, leaf_id, start_block, n_blocks,
                                  route, block_rows, packed4)
    F, npad = binsT.shape
    _check_cuda(binsT.device, binsT=(binsT, torch.uint8),
                leaf_id=(leaf_id, torch.int32))
    _check_route(route)
    if leaf_id.shape != (npad,) or not 0 <= int(route[2]) < F:
        raise ValueError("leaf_id must be [Npad] and the route's bin row "
                         "inside binsT")
    lo, hi = _window(npad, start_block, n_blocks, block_rows)
    rc = kernels.library().lgbt_route_window(
        binsT.data_ptr(), leaf_id.data_ptr(), npad, lo, hi,
        route.data_ptr(), int(packed4), kernels.stream_ptr(binsT.device))
    kernels.check_launch(kernels.variant("route_window", packed4), rc)
    return leaf_id


def route_window_step(binsT: torch.Tensor, leaf_id: torch.Tensor,
                      step: torch.Tensor, block_rows: int,
                      packed4: bool = False) -> torch.Tensor:
    """K2 from a step block: its route applied to ``leaf_id`` in place over
    its window; returns ``leaf_id``, bit for bit route_window's."""
    _check_step(step, binsT.device)
    if _device_kind(binsT) == "cpu":
        return route_window_step_plain(binsT, leaf_id, step, block_rows,
                                       packed4)
    F, npad = binsT.shape
    _check_cuda(binsT.device, binsT=(binsT, torch.uint8),
                leaf_id=(leaf_id, torch.int32))
    if leaf_id.shape != (npad,) or block_rows < 1 or npad % block_rows:
        raise ValueError("leaf_id must be [Npad], Npad a multiple of the "
                         "row block")
    rc = kernels.library().lgbt_route_window_step(
        binsT.data_ptr(), leaf_id.data_ptr(), npad, F, int(block_rows),
        step.data_ptr(), int(packed4), kernels.stream_ptr(binsT.device))
    kernels.check_launch(kernels.variant("route_window_step", packed4), rc)
    return leaf_id


def _first_only(ids: np.ndarray) -> np.ndarray:
    """``ids`` with every repeat of an earlier id set to -1."""
    if len(set(ids.tolist())) == len(ids):
        return ids
    out = np.full_like(ids, -1)
    _, first = np.unique(ids, return_index=True)
    out[first] = ids[first]
    return out


def frontier_params(targets: torch.Tensor, routes) -> np.ndarray:
    """K6/K7's parameter block, as csrc/histogram.cu's FrontierParams lays
    it out: int32 [n_targets, n_routes, n_ids, 0], the targets padded to
    FRONTIER_MAX_TARGETS, the routes' words padded to FRONTIER_MAX_ROUTES
    x ROUTE_WORDS; a host array the launch takes by value.  A target that
    repeats an earlier one, or a route whose leaf repeats an earlier
    route's, is -1 there, so the first wins as the plain versions' first
    match does.  n_ids = 1 + the largest leaf id among the targets and the
    routed leaves (0 when there is none), the length of the kernel's leaf
    tables.  Raises on a frontier wider than the block holds."""
    t = targets.numpy().astype(np.int32)
    r = (np.zeros((0, ROUTE_WORDS), np.int32) if routes is None
         else routes.numpy().astype(np.int32))
    if len(t) > FRONTIER_MAX_TARGETS or len(r) > FRONTIER_MAX_ROUTES:
        raise ValueError(
            f"a frontier of {len(r)} routes and {len(t)} targets exceeds "
            f"the frontier kernel's parameter block ({FRONTIER_MAX_ROUTES} "
            f"routes, {FRONTIER_MAX_TARGETS} targets)")
    t = _first_only(t)
    r[:, 0] = _first_only(r[:, 0])
    n_ids = max(int(t.max(initial=-1)), int(r[:, 0].max(initial=-1))) + 1
    block = np.zeros(_PARAM_HEAD + FRONTIER_MAX_TARGETS
                     + FRONTIER_MAX_ROUTES * ROUTE_WORDS, np.int32)
    block[:3] = (len(t), len(r), n_ids)
    block[_PARAM_HEAD:_PARAM_HEAD + len(t)] = t
    off = _PARAM_HEAD + FRONTIER_MAX_TARGETS
    block[off:off + r.size] = r.reshape(-1)
    return block


def frontier_tiling(num_features: int, num_bins: int, n_targets: int,
                    n_routes: int, n_ids: int, packed4: bool = False,
                    packed_acc: bool = False) -> dict:
    """The card kernel's tiling of K6/K7 at this shape, with leaf tables
    of ``n_ids`` entries (``packed4``: features in pairs; ``packed_acc``:
    12-byte cells): features and target slots a block holds, its shared
    memory, and the feature and target tiles of the grid
    (csrc/histogram.cu lgbt_frontier_tiling)."""
    ft, tt, smem = _tiling(int(num_features), int(num_bins),
                           int(n_targets), int(n_routes), int(n_ids),
                           bool(packed4), bool(packed_acc))
    return {"tile_features": ft, "tile_targets": tt, "smem_bytes": smem,
            "feature_tiles": -(-num_features // ft),
            "target_tiles": -(-n_targets // tt)}


@functools.lru_cache(maxsize=256)
def _tiling(num_features, num_bins, n_targets, n_routes, n_ids, packed4,
            packed_acc):
    out = (ctypes.c_int * 3)()
    rc = kernels.library().lgbt_frontier_tiling(
        num_features, num_bins, n_targets, n_routes, n_ids, int(packed4),
        int(packed_acc), ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"{n_targets} target slots at {num_bins} bins, with "
                         f"leaf tables of {n_ids} ids, do not fit the "
                         "frontier kernel's shared memory")
    return tuple(out)


# per device: the scratch buffers of K1/K3, K5 and K6/K7, all zero between
# launches (a launch's last blocks re-zero what it used; the launches of
# a stream run one after another).  None is ever freed, so a CUDA graph
# that captured one stays valid after a wider launch grew the next.
_SCRATCH: dict = {}


def _kernel_scratch(dev, words: int) -> torch.Tensor:
    held = _SCRATCH.setdefault(dev, [])
    if not held or held[-1].numel() < words:
        size = max(words, 2 * held[-1].numel() if held else 1 << 16)
        held.append(torch.zeros(size, dtype=torch.int64, device=dev))
    return held[-1]


def _launch_frontier(name, binsT, w8, leaf_id, block_list, n_blocks,
                     targets, routes, num_bins, block_rows, scales, packed4):
    rows, npad = binsT.shape
    F = logical_columns(binsT, packed4)
    dev = binsT.device
    _check_cuda(dev, binsT=(binsT, torch.uint8),
                leaf_id=(leaf_id, torch.int32),
                block_list=(block_list, torch.int32),
                scales=(scales, torch.float32))
    acc = _weight_mode(dev, w8, npad)
    if leaf_id.shape != (npad,):
        raise ValueError("leaf_id must be [Npad]")
    _check_bins(num_bins, packed4)
    if scales.shape != (2,):
        raise ValueError("scales must be [2]")
    if npad % block_rows:
        raise ValueError(f"Npad {npad} is not a multiple of the row block "
                         f"{block_rows}")
    if (block_list.dim() != 1
            or not 0 <= int(n_blocks) <= block_list.shape[0]):
        raise ValueError("block_list must be 1-D with n_blocks <= its "
                         "length")
    params = frontier_params(targets, routes)
    KT, K, n_ids = (int(x) for x in params[:3])
    off = _PARAM_HEAD + FRONTIER_MAX_TARGETS
    # the routes' bin rows: their features' columns
    bin_rows = params[off + 2:off + K * ROUTE_WORDS:ROUTE_WORDS]
    if ((bin_rows < 0) | (bin_rows >= rows)).any():
        raise ValueError("a route's bin row is outside binsT")
    # raises where the slots and leaf tables do not fit
    tiling = frontier_tiling(F, num_bins, KT, K, n_ids, packed4, acc)
    tiles = tiling["feature_tiles"] * tiling["target_tiles"]
    # the cells' i64 sums, then one u32 arrival counter a tile
    scratch = _kernel_scratch(dev, KT * F * num_bins * 3 + (tiles + 1) // 2)
    out = torch.empty((KT, F, num_bins, 3), dtype=torch.float32, device=dev)
    rc = kernels.library().lgbt_histogram_frontier(
        binsT.data_ptr(), w8.data_ptr(), leaf_id.data_ptr(), npad, F,
        num_bins, int(block_rows), block_list.data_ptr(), int(n_blocks),
        params.ctypes.data, params.nbytes, scales.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), int(packed4), int(acc),
        kernels.stream_ptr(dev))
    kernels.check_launch(kernels.variant(name, packed4, acc), rc)
    return out


def histogram_frontier(binsT: torch.Tensor, w8: torch.Tensor,
                       leaf_id: torch.Tensor, block_list: torch.Tensor,
                       n_blocks: int, targets: torch.Tensor, num_bins: int,
                       block_rows: int, scales: torch.Tensor,
                       packed4: bool = False) -> torch.Tensor:
    """K6: the histograms of the leaves ``targets`` (a host int32 tensor
    [KT]; -1 = an empty slot, zeros) over the rows of the blocks
    ``block_list[:n_blocks]`` (an int32 tensor on binsT's device) ->
    [KT, F, B, 3] f32, in target order.  ``scales`` is
    fixed_point_scales(w8), or a packed-accumulator stream's quantizer
    scales."""
    _check_frontier_args(targets, None, 0)
    if _device_kind(binsT) == "cpu":
        return histogram_frontier_plain(binsT, w8, leaf_id, block_list,
                                        n_blocks, targets, num_bins,
                                        block_rows, packed4, scales)
    return _launch_frontier("histogram_frontier", binsT, w8, leaf_id,
                            block_list, n_blocks, targets, None, num_bins,
                            block_rows, scales, packed4)


def histogram_frontier_routed(binsT: torch.Tensor, w8: torch.Tensor,
                              leaf_id: torch.Tensor,
                              block_list: torch.Tensor, n_blocks: int,
                              targets: torch.Tensor, routes: torch.Tensor,
                              num_bins: int, block_rows: int,
                              scales: torch.Tensor, packed4: bool = False):
    """K7 with KT = K: apply the K routes ``routes`` [K, 19] (null_route()
    rows for empty slots) to ``leaf_id`` in place over the listed blocks
    AND histogram the K ``targets`` from the updated ids, in one pass.
    Returns ``(leaf_id, [K, F, B, 3])``."""
    _check_frontier_args(targets, routes, 1)
    return _frontier_routed("histogram_frontier_routed", binsT, w8, leaf_id,
                            block_list, n_blocks, targets, routes, num_bins,
                            block_rows, scales, packed4)


def histogram_frontier_fusedk(binsT: torch.Tensor, w8: torch.Tensor,
                              leaf_id: torch.Tensor,
                              block_list: torch.Tensor, n_blocks: int,
                              targets2: torch.Tensor, routes: torch.Tensor,
                              num_bins: int, block_rows: int,
                              scales: torch.Tensor, packed4: bool = False):
    """K7 with KT = 2K: apply the K routes and histogram all 2K children
    in one pass; ``targets2`` is [left children = the routed parents,
    which keep their ids, then right children = the new leaves], -1 for
    an empty slot.  Returns ``(leaf_id, [2K, F, B, 3])`` in that order,
    so the round needs no parent histogram and no subtraction."""
    _check_frontier_args(targets2, routes, 2)
    return _frontier_routed("histogram_frontier_fusedk", binsT, w8,
                            leaf_id, block_list, n_blocks, targets2, routes,
                            num_bins, block_rows, scales, packed4)


def _frontier_routed(name, binsT, w8, leaf_id, block_list, n_blocks,
                     targets, routes, num_bins, block_rows, scales, packed4):
    if _device_kind(binsT) == "cpu":
        return histogram_frontier_routed_plain(
            binsT, w8, leaf_id, block_list, n_blocks, targets, routes,
            num_bins, block_rows, packed4, scales)
    hist = _launch_frontier(name, binsT, w8, leaf_id, block_list, n_blocks,
                            targets, routes, num_bins, block_rows, scales,
                            packed4)
    return leaf_id, hist
