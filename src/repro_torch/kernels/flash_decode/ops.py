"""Wrapper of the flash_decode kernel (``csrc/flash_decode.cu``).

Replaces ``src/repro/kernels/flash_decode/ops.py`` (``decode_partials``,
``decode_attention``) and the Pallas kernel behind them
(``kernel.py::flash_decode_pallas``). On CPU tensors the wrappers run the
plain version (``ref.decode_partials_plain``); on CUDA tensors
they launch the kernel.

Two entry points share the kernel:

* ``decode_partials(q [BH,G,D], k, v [BH,S,D])``, the JAX wrapper's API;
* ``gqa_decode_partials(q [B,Hq,D], k_cache, v_cache [B,S,Hkv,D],
  valid_len)``, the model's: it reads the cache in its own layout through
  strides, and ``valid_len`` (the number of filled slots) may be an int32
  tensor on the card, which the kernel reads there, so a decode step needs
  no host sync.

Both return float32 (acc, m, l) partials, unnormalized, for the
log-sum-exp merge of ``ref.merge_partials``. The kernel cuts the cache
into chunks shared out over ``split_blocks`` blocks per (b, h) and merges
their partials in the same launch: the last block of each (b, h) to finish
merges, found through a per-(b, h) int32 ticket that it resets to zero.
Each launch takes its own zeroed tickets (and partials) from PyTorch's
caching allocator on the current stream, which hands a block to no other
stream while it is in use, and inside a CUDA-graph capture takes it from
the graph's private pool. So calls in flight on different streams, and a
graph replay beside an eager call, never share tickets.

``gqa_decode_partials`` goes through one of two custom operators,
``repro_torch::flash_decode`` (``valid_len`` an int32 tensor, read on the
device) or ``repro_torch::flash_decode_n`` (``valid_len`` an int): a
schema of one type would turn an int into a device tensor on every call,
a copy from the host in each eager step, and inside a capture a tensor
made there. The plain version is their CPU implementation, the kernel
their ``cuda`` one; each has a shape-only (fake) implementation and a
FLOP formula (the products over every slot of the cache, as torch counts
SDPA).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, common
from repro_torch.kernels.flash_decode.ref import decode_partials_plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 160)  # instantiated in csrc/flash_decode.cu
MAX_GROUP = 8  # query heads per KV head the kernel holds in registers
MAX_SPLIT = 64  # blocks per (b, h), so partials per merge
launches = 0  # kernel launches since the last reset


def chunk_slots(d: int, dtype: torch.dtype) -> int:
    """Cache slots per chunk of the kernel instance for (d, dtype)."""
    return build.entry("flash_decode_chunk")(d, DTYPES[dtype])


def split_blocks(n_bh: int, n_chunks: int, dev: torch.device) -> int:
    """Blocks per (b, h): enough for about two blocks an SM over all
    (b, h), a power of two, at most ``n_chunks`` and ``MAX_SPLIT``. Each
    takes every ``split``-th chunk, so a long cache needs no more blocks
    and a block past the filled length exits at once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = 1 << max(0, (-(-2 * sms // n_bh) - 1).bit_length())
    return max(1, min(want, n_chunks, MAX_SPLIT))


def _launch(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, valid_len,
            n_slots: int):
    """q4 [B,H,G,D] and k4, v4 [B,H,S,D] as strided views; returns
    (acc [B,H,G,D], m [B,H,G], l [B,H,G]) in float32."""
    global launches
    b, h, g, d = q4.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {d} not in {HEAD_DIMS}")
    if n_slots == 0:
        raise ValueError("flash_decode: the cache has no slots")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode: group {g} not in 1..{MAX_GROUP}")
    vec = 16 // q4.element_size()  # 16-byte loads of K and V
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.device != q4.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on {q4.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_decode: {name} needs unit stride on D")
    for name, t in (("k", k4), ("v", v4)):
        if t.data_ptr() % 16 or any(t.stride(i) % vec for i in range(3)):
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned "
                             "at every slot")
    dev = q4.device
    acc = torch.empty((b, h, g, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, g), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, g), dtype=torch.float32, device=dev)
    if acc.numel() == 0:
        return acc, m, l
    split = split_blocks(b * h, common.cdiv(n_slots, chunk_slots(d, q4.dtype)), dev)
    if split > 1:  # per-block partials, merged in the same launch
        parts = (torch.empty((split, b, h, g, d), dtype=torch.float32, device=dev),
                 torch.empty((2, split, b, h, g), dtype=torch.float32, device=dev),
                 torch.zeros((b * h,), dtype=torch.int32, device=dev))
        part_ptrs = (parts[0].data_ptr(), parts[1][0].data_ptr(), parts[1][1].data_ptr(),
                     parts[2].data_ptr())
    else:
        part_ptrs = (0, 0, 0, 0)
    if isinstance(valid_len, torch.Tensor):
        if valid_len.dtype != torch.int32 or valid_len.device != dev \
                or valid_len.numel() != 1:
            raise ValueError("flash_decode: valid_len must be one int32 on the "
                             "kernel's device")
        len_ptr, len_host = valid_len.data_ptr(), 0
    else:
        len_ptr, len_host = 0, int(valid_len)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q4, k4, v4)
                                        for i in range(3)))
    with torch.cuda.device(dev):
        rc = build.entry("flash_decode")(
            ctypes.c_void_p(q4.data_ptr()), ctypes.c_void_p(k4.data_ptr()),
            ctypes.c_void_p(v4.data_ptr()), ctypes.c_void_p(acc.data_ptr()),
            ctypes.c_void_p(m.data_ptr()), ctypes.c_void_p(l.data_ptr()),
            *(ctypes.c_void_p(p) for p in part_ptrs),
            ctypes.c_void_p(len_ptr), len_host, b, h, g, n_slots, d,
            split, DTYPES[q4.dtype], d ** -0.5, strides,
            ctypes.c_void_p(common.stream_ptr(q4)))
    if rc != 0:
        raise RuntimeError(f"flash_decode: launch failed, CUDA error {rc}")
    launches += 1
    return acc, m, l


def _check_dtypes(q, k, v) -> None:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}, {k.dtype}, {v.dtype}")


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q: [BH, G, D]; k,v: [BH, S, D]. Returns (acc [BH,G,D], m [BH,G],
    l [BH,G]), unnormalized partials for the merge over cache shards."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_decode: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    acc, m, l = gqa_decode_partials(q, k[:, :, None], v[:, :, None], k.shape[1])
    return acc[:, 0], m[:, 0], l[:, 0]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-shard convenience: normalized one-token attention."""
    acc, _, l = decode_partials(q, k, v)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _partials_out(q: torch.Tensor, k_cache: torch.Tensor):
    """Empty float32 (acc [B,Hkv,G,D], m [B,Hkv,G], l [B,Hkv,G])."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    shape = (b, hkv, hq // hkv)
    return (torch.empty(shape + (d,), dtype=torch.float32, device=q.device),
            torch.empty(shape, dtype=torch.float32, device=q.device),
            torch.empty(shape, dtype=torch.float32, device=q.device))


def _plain(q, k_cache, v_cache, valid_len):
    out = _partials_out(q, k_cache)
    for dst, got in zip(out, decode_partials_plain(q, k_cache, v_cache, valid_len,
                                                   q.shape[2] ** -0.5)):
        dst.copy_(got)
    return out


def _kernel(q, k_cache, v_cache, valid_len):
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    return _launch(q.reshape(b, hkv, hq // hkv, d), k_cache.transpose(1, 2),
                   v_cache.transpose(1, 2), valid_len, k_cache.shape[1])


def _fake(q, k_cache, v_cache, valid_len):
    """The kernel's outputs, refusing what its launch refuses (where the
    sizes are known: a symbolic one, under ``torch.compile``'s dynamic
    shapes, is not)."""
    b, hq, d = q.shape
    if not all(isinstance(n, int) for n in (hq, d, k_cache.shape[1], k_cache.shape[2])):
        return _partials_out(q, k_cache)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {d} not in {HEAD_DIMS}")
    if k_cache.shape[1] == 0:
        raise ValueError("flash_decode: the cache has no slots")
    if not 1 <= hq // k_cache.shape[2] <= MAX_GROUP:
        raise ValueError(f"flash_decode: group {hq // k_cache.shape[2]} not in "
                         f"1..{MAX_GROUP}")
    return _partials_out(q, k_cache)


Partials = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(), device_types="cpu")
def _decode_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               valid_len: torch.Tensor) -> Partials:
    return _plain(q, k_cache, v_cache, valid_len)


@torch.library.custom_op("repro_torch::flash_decode_n", mutates_args=(), device_types="cpu")
def _decode_n_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 valid_len: int) -> Partials:
    return _plain(q, k_cache, v_cache, valid_len)


for _op in (_decode_op, _decode_n_op):
    _op.register_kernel("cuda")(_kernel)
    _op.register_fake(_fake)


@register_flop_formula([torch.ops.repro_torch.flash_decode,
                        torch.ops.repro_torch.flash_decode_n])
def _decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """q k^T and P v over every slot of the cache, filled or not."""
    b, hq, d = q_shape
    return 4 * b * hq * k_shape[1] * d


def gqa_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, valid_len):
    """q: [B, Hq, D]; k_cache, v_cache: [B, S, Hkv, D]; valid_len: filled
    slots (int, or an int32 tensor on q's device). Returns (acc
    [B,Hkv,G,D], m [B,Hkv,G], l [B,Hkv,G]) with G = Hq // Hkv."""
    b, hq, d = q.shape
    if k_cache.ndim != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or hq % k_cache.shape[2] != 0:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    _check_dtypes(q, k_cache, v_cache)
    if isinstance(valid_len, torch.Tensor):
        return _decode_op(q, k_cache, v_cache, valid_len)
    return _decode_n_op(q, k_cache, v_cache, int(valid_len))
