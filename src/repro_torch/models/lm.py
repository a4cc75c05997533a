"""Language models: parameter init, forward, prefill, decode, for every family.

Ported from ``repro.models.lm``:

* decoders with ``kind`` "dense" or "moe" and ``attn`` "gqa", "mrope" or
  "mla" (granite-3-2b, stablelm-12b, deepseek-67b, nemotron-4-15b,
  granite-moe-1b-a400m, qwen2-vl-72b, deepseek-v2-236b);
* the encoder-decoder, ``kind == "encdec"`` with GQA attention
  (seamless-m4t-medium): ``encode``, then decoder layers that run
  self-attention, cross-attention over the encoder's memory and the FFN;
* the hybrid, ``kind == "hybrid"`` (zamba2-1.2b): Mamba-2 layers with one
  shared attention + MLP block after every ``attn_every`` of them, the last
  partial segment too;
* xLSTM, ``kind == "xlstm"`` (xlstm-1.3b): segments of mLSTM layers, each
  closed by an sLSTM layer.

Params are a plain dict of tensors with the JAX package's key names, the
layers stacked on a leading axis (``params["blocks"]["wq"]`` is [L, D,
H*hd]); the layers run as a Python loop over that axis. Prefill attention
(self, cross, MLA's and the hybrid's shared block) goes through the
flash_attention kernel, GQA decode attention through the flash_decode
kernel; on CPU tensors their wrappers run the plain versions, op for op
the JAX package's jnp functions. MLA's decode attends in its latent space
(the absorbed ``w_uk`` / ``w_uv``), as the reference's own float32 einsums
outside any kernel; the Mamba-2, mLSTM and sLSTM layers are ``models.ssm``.

Unlike the JAX package, ``decode_step`` updates its cache in place (the
returned cache holds the same tensors and a new ``len``): K/V, MLA's latent
rows, the hybrid's conv and SSM states, xLSTM's memories. A copy of a
1.3 GB cache per step would cost more than the step. The step reads
nothing back to the host, so ``launch.serve.Server`` captures it into one
CUDA graph, as the reference's server jits it.

Training (``loss_fn``, ``value_and_grad``, ``make_train_step``) runs on
autograd: the flash_attention kernel takes part through its
``FlashAttentionFn``, whose backward is a kernel too, and ``cfg.remat``
rematerializes the reference's ``jax.checkpoint`` sites (a decoder's
layers, the Mamba-2 and mLSTM layers, the CE chunks) with
``torch.utils.checkpoint`` when a tensor requires grad. The stacked
weights are unbound once a forward (``_layers``), so the backward stacks
each leaf's gradient once.

``mesh=`` (a (data, model) or (pod, data, model) mesh of
``core.mesh.make_host_mesh``) runs the reference's sharded paths on ranks
that all run the same program: the MoE splits its experts over ``model``
(``layers.moe_block``) in ``forward``,
``prefill`` and the decode step; the decode step attends over a cache whose
slots are split over ``model`` and rows over the batch axes
(``layers.sharded_decode_attention`` for GQA and the hybrid's shared block,
``mla_latent_attention`` for MLA). On a mesh, params and the cache are each
rank's (``models.sharding``: ``init_params(mesh=)`` or ``shard_params``;
``prefill(mesh=)`` returns the rank's cache); all else is whole and
computed on every rank. The encoder-decoder and xLSTM decode on one device,
as in the reference.

Training on a mesh (``loss_fn``, ``value_and_grad`` and ``make_train_step``
with ``mesh=``) runs data-parallel over the batch axes (``data``, or
``pod`` and ``data`` on a (pod, data, model) mesh) on each rank's rows of
the batch, gathers FSDP weights at their use (``_gather_fsdp``) and splits
the experts over ``model``; the collectives carry the gradients
(``core.mesh.{sum_over,copy_to,gather_rows,split_rows}``). Params and
moments are the rank's training placement (``sharding.train_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mesh as mesh_util
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import layers as L
from repro_torch.models import sharding, ssm
from repro_torch.models.config import ModelConfig

# leaves the reference's init sets to constants: norms to one, and the
# Mamba-2 gates' dt_bias, A_log and D_skip
NORMS = ("ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm", "q_ln", "kv_ln")
CONSTANTS = {"dt_bias": -2.0, "A_log": 0.0, "D_skip": 1.0}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raises ValueError for a kind and attention pair that no config of the
    reference has; every config of ``repro_torch.configs`` passes."""
    decoder = cfg.kind in ("dense", "moe") and cfg.attn in ("gqa", "mla", "mrope")
    other = cfg.kind in ("encdec", "hybrid", "xlstm") and cfg.attn == "gqa"
    if not (decoder or other):
        raise ValueError(f"{cfg.name}: kind={cfg.kind!r} attn={cfg.attn!r}")


# ===========================================================================
# parameter initialization
# ===========================================================================

def _dense_block_shapes(cfg: ModelConfig, n_layers: int) -> Dict[str, Tuple]:
    D, hd = cfg.d_model, cfg.hd
    s = {"ln1": (n_layers, D), "ln2": (n_layers, D)}
    if cfg.attn == "mla":
        m = cfg.mla
        qk = m.nope_dim + m.rope_dim
        s.update({"wq_a": (n_layers, D, m.q_lora), "q_ln": (n_layers, m.q_lora),
                  "wq_b": (n_layers, m.q_lora, cfg.n_heads * qk),
                  "wkv_a": (n_layers, D, m.kv_lora + m.rope_dim),
                  "kv_ln": (n_layers, m.kv_lora),
                  "wkv_b": (n_layers, m.kv_lora, cfg.n_heads * (m.nope_dim + m.v_dim)),
                  "wo": (n_layers, cfg.n_heads * m.v_dim, D)})
    else:
        s.update({"wq": (n_layers, D, cfg.n_heads * hd),
                  "wk": (n_layers, D, cfg.n_kv_heads * hd),
                  "wv": (n_layers, D, cfg.n_kv_heads * hd),
                  "wo": (n_layers, cfg.n_heads * hd, D)})
    if cfg.moe is not None:
        mo = cfg.moe
        s["router"] = (n_layers, D, mo.n_experts)
        s["e_in"] = (n_layers, mo.n_experts, D, mo.d_expert)
        s["e_out"] = (n_layers, mo.n_experts, mo.d_expert, D)
        if cfg.act == "swiglu":
            s["e_gate"] = (n_layers, mo.n_experts, D, mo.d_expert)
        if mo.n_shared:
            s["sh_in"] = (n_layers, D, mo.n_shared * mo.d_shared)
            s["sh_out"] = (n_layers, mo.n_shared * mo.d_shared, D)
            if cfg.act == "swiglu":
                s["sh_gate"] = (n_layers, D, mo.n_shared * mo.d_shared)
    else:
        s["w_in"] = (n_layers, D, cfg.d_ff)
        s["w_out"] = (n_layers, cfg.d_ff, D)
        if cfg.act == "swiglu":
            s["w_gate"] = (n_layers, D, cfg.d_ff)
    return s


def _mamba_shapes(cfg: ModelConfig, n_layers: int) -> Dict[str, Tuple]:
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    return {"ln": (n_layers, D),
            "w_in": (n_layers, D, d_in), "w_z": (n_layers, D, d_in),
            "w_bc": (n_layers, D, 2 * cfg.ssm_state),
            "w_dt": (n_layers, D, cfg.n_heads), "dt_bias": (n_layers, cfg.n_heads),
            "conv_w": (n_layers, cfg.conv_width, d_in),
            "A_log": (n_layers, cfg.n_heads), "D_skip": (n_layers, cfg.n_heads),
            "w_out": (n_layers, d_in, D)}


def _mlstm_shapes(cfg: ModelConfig, n_layers: int) -> Dict[str, Tuple]:
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    return {"ln": (n_layers, D),
            "w_q": (n_layers, D, d_in), "w_k": (n_layers, D, d_in),
            "w_v": (n_layers, D, d_in), "w_o": (n_layers, D, d_in),
            "w_gates": (n_layers, D, 2 * cfg.n_heads),
            "w_out": (n_layers, d_in, D)}


def _slstm_shapes(cfg: ModelConfig, n_layers: int) -> Dict[str, Tuple]:
    D = cfg.d_model
    return {"ln": (n_layers, D), "w_gates": (n_layers, D, 4 * D),
            "r_gates": (n_layers, D, 4 * D), "w_out": (n_layers, D, D)}


def _xlstm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(segments, mLSTM layers a segment): each segment of ``slstm_every``
    layers is that many mLSTM layers less one, then one sLSTM layer."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def _n_attn(cfg: ModelConfig) -> int:
    """The hybrid's shared-block applications: one after every
    ``attn_every`` Mamba-2 layers and one after a last partial segment."""
    return -(-cfg.n_layers // cfg.attn_every)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    D, V, hd = cfg.d_model, cfg.padded_vocab, cfg.hd
    tree: Dict[str, Any] = {"embed": (V, D), "final_norm": (D,)}
    if cfg.kind == "xlstm":
        n_seg, per = _xlstm_layout(cfg)
        tree["mlstm"] = _mlstm_shapes(cfg, n_seg * per)
        tree["slstm"] = _slstm_shapes(cfg, n_seg)
        return tree
    if cfg.kind == "hybrid":
        tree["mamba"] = _mamba_shapes(cfg, cfg.n_layers)
        tree["shared_attn"] = {  # ONE attention + MLP block, shared (zamba2)
            "ln1": (D,), "ln2": (D,),
            "wq": (D, cfg.n_heads * hd), "wk": (D, cfg.n_kv_heads * hd),
            "wv": (D, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, D),
            "w_gate": (D, cfg.d_ff), "w_in": (D, cfg.d_ff), "w_out": (cfg.d_ff, D)}
        return tree
    tree["blocks"] = _dense_block_shapes(cfg, cfg.n_layers)
    if cfg.kind == "encdec":
        n = cfg.n_layers
        tree["enc_blocks"] = _dense_block_shapes(cfg, cfg.enc_layers)
        tree["cross"] = {"ln_x": (n, D), "xq": (n, D, cfg.n_heads * hd),
                         "xk": (n, D, cfg.n_kv_heads * hd),
                         "xv": (n, D, cfg.n_kv_heads * hd),
                         "xo": (n, cfg.n_heads * hd, D)}
        tree["enc_norm"] = (D,)
    return tree


def init_params(cfg: ModelConfig, seed: int = 0, device=None, mesh=None) -> Dict[str, Any]:
    """Random params with the JAX package's scheme: normal / sqrt(fan_in),
    norms and 1-D leaves at one, ``dt_bias`` -2, ``A_log`` 0, ``D_skip`` 1.
    The numbers come from a ``torch.Generator`` seeded with ``seed`` on the
    target device, so they differ from ``jax.random``'s; tests carry JAX
    params across with ``convert.lm_params_from_numpy``. A stacked leaf is
    drawn one layer at a time in float32 and stored in the model's type, so
    the float32 transient is one layer's (5 GB for deepseek-v2's ``e_in``).
    With ``mesh=`` the experts are this rank's block over ``model``
    (``sharding.shard_params``'s cut of the whole leaf): each layer is drawn
    whole, as without a mesh, and only the block is kept. On the ``meta``
    device the leaves have their shapes and types and no values
    (``abstract_params``)."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
    shapes = param_shapes(cfg)
    cut = sharding.sharded_experts(cfg, mesh)
    specs = sharding.param_pspecs(cfg, shapes, mesh) if cut else None

    def mk(name, shape, spec):
        if name in NORMS or len(shape) == 1:
            return torch.ones(shape, dtype=dt, device=dev)
        if name in CONSTANTS:
            return torch.full(shape, CONSTANTS[name], dtype=dt, device=dev)
        keep = ((lambda w: sharding.block_view(w, spec[1:], mesh, ("model",)))
                if cut and name in sharding.EXPERTS else (lambda w: w))
        out = torch.empty((shape[0],) + keep(torch.empty(shape[1:], device="meta")).shape
                          if len(shape) >= 3 else shape, dtype=dt, device=dev)
        if meta:
            return out
        fan_in = np.sqrt(max(shape[-2], 1))
        for part in (out if len(shape) >= 3 else [out]):  # a layer at a time
            whole = shape[1:] if len(shape) >= 3 else shape
            part.copy_(keep(torch.randn(whole, generator=gen, dtype=torch.float32,
                                        device=dev).div_(fan_in)))
        return out

    def build(tree, spec):  # leaves in the JAX tree's flattening order (sorted keys)
        return {n: build(v, spec and spec[n]) if isinstance(v, dict)
                else mk(n, v, spec and spec[n]) for n, v in sorted(tree.items())}

    return build(shapes, specs)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The params' shapes and types without values: ``init_params`` on the
    ``meta`` device (the reference's ``jax.eval_shape`` of its init)."""
    return init_params(cfg, device="meta")


def _layers(blocks: Dict[str, torch.Tensor]) -> list:
    """The stacked leaves of ``blocks`` as one dict of views per layer, each
    leaf unbound once: under autograd an unbind's backward stacks the
    layers' gradients into one tensor, where a select per layer would write
    a zero tensor of the whole stack for each layer (40 x 4.9 GB a step at
    granite-3-2b's width)."""
    names = list(blocks)
    return [dict(zip(names, ws)) for ws in zip(*(torch.unbind(blocks[n]) for n in names))]


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, rematerialized in the backward (``torch.utils.checkpoint``)
    when training: ``cfg.remat``, grad mode on and a tensor among ``args``
    (dicts of tensors included) that requires grad. The reference applies
    ``jax.checkpoint`` at the same sites; prefill and decode run ``fn``."""
    def needs_grad(a):
        if isinstance(a, dict):
            return any(needs_grad(v) for v in a.values())
        return isinstance(a, torch.Tensor) and a.requires_grad
    if cfg.remat and torch.is_grad_enabled() and any(needs_grad(a) for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    # JAX's gather wraps negative ids once and clamps the rest into range
    n = emb.shape[0]
    tokens = torch.where(tokens < 0, tokens + n, tokens).clamp(0, n - 1)
    return emb[tokens].to(_dt(cfg))


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["embed"].float().T


def _final_norm(params, x: torch.Tensor, last=None) -> torch.Tensor:
    """The final norm of x, or of ``x + last``: in the hybrid and xLSTM the
    reference's last residual add sits outside any scan, and XLA fuses it
    into the norm, which reads the float32 sum (``layers.add_rms_norm``) in
    ``forward`` and the decode step. The other families end in a scan,
    whose carry is rounded."""
    if last is None:
        return L.rms_norm(x, params["final_norm"])
    return L.add_rms_norm(x, last, params["final_norm"])[1]


# ===========================================================================
# attention: GQA self and cross, MLA
# ===========================================================================

def _rotate(q, k, cfg: ModelConfig, positions, pos3):
    if cfg.attn == "mrope":
        return (L.apply_mrope(q, pos3, theta=cfg.rope_theta),
                L.apply_mrope(k, pos3, theta=cfg.rope_theta))
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta))


def _attend(q, k, v, causal: bool):
    """q [B,S,H,D], k [B,Skv,Hkv,D] and v [B,Skv,Hkv,Dv] -> [B, S, H*Dv].
    They go to the kernel as [B,H,S,*] views; o comes back in q's [B,S,H,Dv]
    memory layout, so the reshape is free."""
    b, s = q.shape[:2]
    o = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2).reshape(b, s, -1)


def _attn_prefill(x, blk, cfg: ModelConfig, positions, pos3, causal=True):
    """Self-attention over x; returns its output and the rotated (k, v)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ blk["wq"]).view(b, s, cfg.n_heads, hd)
    k = (x @ blk["wk"]).view(b, s, cfg.n_kv_heads, hd)
    v = (x @ blk["wv"]).view(b, s, cfg.n_kv_heads, hd)
    q, k = _rotate(q, k, cfg, positions, pos3)
    return _attend(q, k, v, causal) @ blk["wo"], (k, v)


def _mla_prefill(x, blk, cfg: ModelConfig, positions):
    """MLA self-attention over x (``repro.models.lm._mla_prefill``): the
    decompressed K and V of all heads, the rotary part of K shared by the
    heads (broadcast and concatenated, as the reference does), through
    flash_attention at (D, Dv) = (nope + rope, v). Returns its output and
    the cache's rows (the normed latent ``ckv`` and the rotated ``kpe``)."""
    m = cfg.mla
    b, s, _ = x.shape
    H = cfg.n_heads
    q = (L.rms_norm(x @ blk["wq_a"], blk["q_ln"]) @ blk["wq_b"]).view(
        b, s, H, m.nope_dim + m.rope_dim)
    q_nope, q_pe = q[..., :m.nope_dim], q[..., m.nope_dim:]
    kv = x @ blk["wkv_a"]
    ckv = L.rms_norm(kv[..., :m.kv_lora], blk["kv_ln"])
    k_pe = kv[..., m.kv_lora:].reshape(b, s, 1, m.rope_dim)
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)
    k_pe = L.apply_rope(k_pe, positions, cfg.rope_theta)
    kvb = (ckv @ blk["wkv_b"]).view(b, s, H, m.nope_dim + m.v_dim)
    k_nope, v = kvb[..., :m.nope_dim], kvb[..., m.nope_dim:]
    k = torch.cat([k_nope, k_pe.expand(b, s, H, m.rope_dim)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    return _attend(qq, k, v, causal=True) @ blk["wo"], (ckv, k_pe[:, :, 0])


def _cross_attn(x, xblk, cfg: ModelConfig, enc_h):
    """Cross-attention of x over the encoder's memory (no rotary, no mask)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ xblk["xq"]).view(b, s, cfg.n_heads, hd)
    k = (enc_h @ xblk["xk"]).view(b, -1, cfg.n_kv_heads, hd)
    v = (enc_h @ xblk["xv"]).view(b, -1, cfg.n_kv_heads, hd)
    return _attend(q, k, v, causal=False) @ xblk["xo"]


def _gather_fsdp(blk, cfg: ModelConfig, mesh, specs, sum_grads: bool = True):
    """FSDP unshard-at-use (``repro.models.lm._gather_fsdp``) on ranks: each
    leaf of ``blk`` whose spec puts a dim on ``data`` holds this rank's
    block of that dim and is all-gathered over ``data`` to the whole leaf
    (``core.mesh.gather_rows``: under autograd its gradient is the rank's
    block of the gradient, summed over ``data`` when ``sum_grads``, the
    data-parallel case). ``specs``: each leaf's spec, one layer's
    (``sharding.train_specs`` without the stacked axis). Over
    ``model`` a gathered weight is whole, as the port keeps every weight
    but the experts whole there. Training on a mesh applies it at each
    layer's use, inside the layer's rematerialized body, and to ``embed``
    (``_Train.use``); ``forward`` on a mesh (serving) takes whole weights."""
    if mesh is None or not cfg.fsdp:
        return blk
    out = dict(blk)
    for name, w in blk.items():
        spec = specs[name]
        if ("data",) in spec:
            dim = spec.index(("data",))
            out[name] = mesh_util.gather_rows(w.movedim(dim, 0), mesh, "data",
                                              sum_grads).movedim(0, dim)
    return out


class _Train(NamedTuple):
    """A training pass on a (data, model) or (pod, data, model) mesh:
    ``split`` when each rank runs its own rows of the batch over the batch
    axes (its gradients are then partial sums over them), else every rank
    runs the whole batch (the reference's ``batch_spec`` replicates a
    batch whose rows do not divide); ``specs`` is the params' placement
    (``sharding.train_specs``)."""
    mesh: Any
    split: bool
    specs: Dict[str, Any]

    def use(self, tree, cfg: ModelConfig, group: str = ""):
        """``tree`` (one layer of the stacked ``group``, or the top-level
        leaves) with its FSDP leaves gathered whole (``_gather_fsdp``)."""
        if not cfg.fsdp:
            return tree
        specs = self.specs[group] if group else self.specs
        cut = 1 if group in sharding._STACKED_GROUPS else 0
        return _gather_fsdp(tree, cfg, self.mesh, {k: specs[k][cut:] for k in tree},
                            self.split)


def _use(train, tree, cfg: ModelConfig, group: str = ""):
    return tree if train is None else train.use(tree, cfg, group)


def _ffn(x, blk, cfg: ModelConfig, mesh=None, local_rows: bool = False):
    if cfg.moe is None:
        return L.mlp(x, blk.get("w_gate"), blk["w_in"], blk["w_out"], cfg.act)
    flat = x.reshape(-1, x.shape[-1])
    y = L.moe_block(flat, blk["router"], blk.get("e_gate"), blk["e_in"],
                    blk["e_out"], cfg, mesh=mesh, local_rows=local_rows)
    if cfg.moe.n_shared:
        y = y + L.mlp(flat, blk.get("sh_gate"), blk["sh_in"], blk["sh_out"], cfg.act)
    return y.reshape(x.shape)


def _cache_rows(cfg: ModelConfig) -> Tuple[str, str]:
    """The cache's per-layer rows of a decoder: MLA's latent and rotary key,
    else the K and V of the KV heads."""
    return ("ckv", "kpe") if cfg.attn == "mla" else ("k", "v")


def _stack(x, blocks, cfg: ModelConfig, positions, pos3, causal=True,
           cross=None, enc_h=None, cache=None, mesh=None, train=None, group="blocks"):
    """The stacked layers of ``blocks`` over x: self-attention (GQA or
    MLA), then (with ``cross``) cross-attention over ``enc_h``, then the
    FFN (expert-parallel on ``mesh``). With ``cache`` each layer's rows go
    to its first S slots. In training each layer is rematerialized
    (``_remat``), as the reference's scan body; on a mesh (``train``) the
    layer gathers its FSDP weights inside that body, so that the backward
    gathers them again instead of keeping them."""
    s = x.shape[1]
    if train is not None:
        mesh = train.mesh

    def layer(x, blk, xblk):
        blk = _use(train, blk, cfg, group)
        xblk = xblk if xblk is None else _use(train, xblk, cfg, "cross")
        h = L.rms_norm(x, blk["ln1"])
        if cfg.attn == "mla":
            a, rows = _mla_prefill(h, blk, cfg, positions)
        else:
            a, rows = _attn_prefill(h, blk, cfg, positions, pos3, causal)
        if xblk is not None:
            x, h = L.add_rms_norm(x, a, xblk["ln_x"])
            a = _cross_attn(h, xblk, cfg, enc_h)
        x, h = L.add_rms_norm(x, a, blk["ln2"])
        return x + _ffn(h, blk, cfg, mesh, train is not None and train.split), rows

    layers = _layers(blocks)
    xlayers = _layers(cross) if cross is not None else [None] * len(layers)
    for i, (blk, xblk) in enumerate(zip(layers, xlayers)):
        x, rows = _remat(cfg, layer, x, blk, xblk)
        if cache is not None:
            for name, row in zip(_cache_rows(cfg), rows):
                cache[name][i, :, :s] = row
    return x


def _shared_block(x, sh, cfg: ModelConfig, positions):
    """The hybrid's shared attention + SwiGLU block over x: (the block's
    input plus its attention, the MLP's output, the rotated (k, v))."""
    a, kv = _attn_prefill(L.rms_norm(x, sh["ln1"]), sh, cfg, positions, None)
    x, h = L.add_rms_norm(x, a, sh["ln2"])
    return x, L.mlp(h, sh["w_gate"], sh["w_in"], sh["w_out"], "swiglu"), kv


def _hybrid(x, params, cfg: ModelConfig, positions, cache=None, train=None):
    """Mamba-2 layers, the shared block after every ``attn_every`` of them
    and after the last; returns (x, the last residual term) for the final
    norm. With ``cache``: each layer's conv and SSM states, each shared
    application's K and V in its first S slots. In training each Mamba-2
    layer is rematerialized, as the reference's scan body; the shared block
    is not (the reference's sits outside the scan)."""
    mp, sh = params["mamba"], params["shared_attn"]
    layers, s = _layers(mp), x.shape[1]
    n = len(layers)
    last = torch.zeros_like(x)

    def mamba(x, blk):
        blk = _use(train, blk, cfg, "mamba")
        return ssm.mamba2_forward(L.rms_norm(x, blk["ln"]), blk, cfg)

    for i, blk in enumerate(layers):
        x = x + last
        last, (conv_s, ssm_s) = _remat(cfg, mamba, x, blk)
        if cache is not None:
            cache["conv"][i] = conv_s
            cache["ssm"][i] = ssm_s
        if (i + 1) % cfg.attn_every == 0 or i + 1 == n:
            x, last, (k, v) = _shared_block(x + last, _use(train, sh, cfg, "shared_attn"),
                                            cfg, positions)
            if cache is not None:
                cache["k"][i // cfg.attn_every, :, :s] = k
                cache["v"][i // cfg.attn_every, :, :s] = v
    return x, last


def _xlstm(x, params, cfg: ModelConfig, cache=None, train=None):
    """Each segment's mLSTM layers, then its sLSTM layer; returns (x, the
    last residual term) for the final norm. With ``cache``: the memories
    each layer ends with. In training the mLSTM layers are rematerialized,
    as the reference's scan body; the sLSTM layers are not."""
    n_seg, per = _xlstm_layout(cfg)
    mlstm, slstm = _layers(params["mlstm"]), _layers(params["slstm"])
    last = torch.zeros_like(x)

    def m_body(x, blk):
        blk = _use(train, blk, cfg, "mlstm")
        return ssm.mlstm_forward(L.rms_norm(x, blk["ln"]), blk, cfg)

    for si in range(n_seg):
        for li in range(si * per, (si + 1) * per):
            x = x + last
            last, (S,) = _remat(cfg, m_body, x, mlstm[li])
            if cache is not None:
                cache["mS"][li] = S
        x = x + last
        sl = _use(train, slstm[si], cfg, "slstm")
        last, state = ssm.slstm_forward(L.rms_norm(x, sl["ln"]), sl, cfg)
        if cache is not None:
            for name, t in zip(("sh", "sc", "sn"), state):
                cache[name][si] = t
    return x, last


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _pos3(cfg: ModelConfig, positions, pos3):
    """M-RoPE's [3, B, S] ids: the 1-D positions on all three rows unless
    given (the stubbed vision frontend supplies them)."""
    if cfg.attn != "mrope":
        return None
    if pos3 is None:
        return positions[None].expand(3, *positions.shape)
    return torch.as_tensor(pos3, device=positions.device)


def encode(params, cfg: ModelConfig, enc_embeds) -> torch.Tensor:
    """Encoder pass of the encoder-decoder: frame embeddings [B, S_src, D]
    (the stubbed modality frontend's output) -> memory [B, S_src, D]."""
    return _encode(params, cfg, enc_embeds)


def _encode(params, cfg: ModelConfig, enc_embeds, train=None) -> torch.Tensor:
    check_supported(cfg)
    if cfg.kind != "encdec" or enc_embeds is None:
        raise ValueError(f"{cfg.name}: encode needs an encoder-decoder and enc_embeds")
    e = torch.as_tensor(enc_embeds, device=params["embed"].device).to(_dt(cfg))
    b, s = e.shape[:2]
    e = _stack(e, params["enc_blocks"], cfg, _positions(b, s, e.device), None,
               causal=False, train=train, group="enc_blocks")
    return L.rms_norm(e, params["enc_norm"])


def _body(params, cfg: ModelConfig, x, positions, pos3, enc_h, cache=None, mesh=None,
          train=None):
    """The layers of any family over the embedded tokens x; returns (x,
    the last residual term or None) for ``_final_norm``."""
    if cfg.kind == "hybrid":
        return _hybrid(x, params, cfg, positions, cache, train)
    if cfg.kind == "xlstm":
        return _xlstm(x, params, cfg, cache, train)
    x = _stack(x, params["blocks"], cfg, positions, _pos3(cfg, positions, pos3),
               cross=params.get("cross"), enc_h=enc_h, cache=cache, mesh=mesh, train=train)
    return x, None


def forward(params, cfg: ModelConfig, tokens, positions=None, pos3=None,
            enc_embeds=None, mesh=None) -> torch.Tensor:
    """Returns final hidden states [B, S, D]. tokens: [B, S] int (the
    decoder's input); enc_embeds: [B, S_src, D] for the encoder-decoder;
    pos3: [3, B, S] for M-RoPE; ``mesh``: the MoE's experts split over its
    ``model`` axis (``params`` are this rank's)."""
    return _forward(params, cfg, tokens, positions, pos3, enc_embeds, mesh)


def _forward(params, cfg: ModelConfig, tokens, positions=None, pos3=None,
             enc_embeds=None, mesh=None, train=None) -> torch.Tensor:
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, x.device)
    enc_h = _encode(params, cfg, enc_embeds, train) if cfg.kind == "encdec" else None
    return _final_norm(params, *_body(params, cfg, x, positions, pos3, enc_h, mesh=mesh,
                                      train=train))


# ===========================================================================
# loss (chunked CE) and train step
# ===========================================================================

def loss_fn(params, cfg: ModelConfig, batch, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens`` [B,S] and
    ``labels`` [B,S], -1 masked; ``enc_embeds`` and ``pos3`` when the family
    takes them), the reference's ``loss_fn``: the final hidden states in
    chunks of ``cfg.loss_chunk`` positions (the tail padded with masked
    rows), float32 logits against ``embed.T`` with -1e30 past ``cfg.vocab``,
    the chunks' sums added in the reference's scan order, ``tot / max(cnt,
    1)``. Each chunk is rematerialized in training, as the reference's.

    On ``mesh`` (training on a (data, model) mesh) ``params`` are this
    rank's placement (``sharding.train_specs``: FSDP blocks over ``data``,
    experts over ``model``) and ``batch`` is the whole batch; every rank
    returns the whole batch's loss (``_train_loss``)."""
    if mesh is None:
        tot, cnt = _ce_sums(params, cfg, batch)
        return tot / torch.clamp(cnt, min=1.0)
    return _train_loss(params, cfg, batch, _train_place(cfg, mesh, batch))


def _ce_sums(params, cfg: ModelConfig, batch, train=None):
    """(sum of the masked tokens' cross-entropies, their count) of
    ``batch``, both float32 0-d tensors."""
    h = _forward(params, cfg, batch["tokens"], enc_embeds=batch.get("enc_embeds"),
                 pos3=batch.get("pos3"), train=train)
    b, s, _ = h.shape
    labels = torch.as_tensor(batch["labels"], device=h.device).long()
    chunk = min(cfg.loss_chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    emb = params["embed"].float()
    in_vocab = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab

    def ce(hh, ll, emb):
        logits = torch.where(in_vocab, hh.float() @ emb.T, L.NEG)
        gold = logits.gather(-1, ll.clamp(min=0)[..., None])[..., 0]
        mask = (ll >= 0).float()
        return ((torch.logsumexp(logits, -1) - gold) * mask).sum(), mask.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, nc * chunk, chunk):
        t, n = _remat(cfg, ce, h[:, c:c + chunk], labels[:, c:c + chunk], emb)
        tot, cnt = tot + t, cnt + n
    return tot, cnt


def _batch_axis(key: str) -> int:
    return 1 if key == "pos3" else 0  # pos3 is [3, B, S]


def _train_place(cfg: ModelConfig, mesh, batch, specs=None) -> _Train:
    """How a training pass over ``batch`` runs on ``mesh``: split over
    ``data`` when its rows divide there (``sharding.batch_rows``)."""
    n = torch.as_tensor(batch["tokens"]).shape[0]
    if specs is None:
        specs = sharding.train_specs(cfg, param_shapes(cfg), mesh)
    return _Train(mesh, sharding.batch_rows(mesh, n) is not None, specs)


def _train_loss(params, cfg: ModelConfig, batch, train: _Train) -> torch.Tensor:
    """The loss of a training pass on a mesh. Split over the batch axes
    (``data``, or ``pod`` and ``data``): the rank runs its rows (``pos3``
    on axis 1, ``enc_embeds`` by rows) and computes ``tot_local / cnt``
    with ``cnt`` the whole batch's count (summed over the batch axes, no
    gradient), and the ranks' terms are summed with a gradient that passes
    through (``core.mesh.sum_over``): each rank's gradient is its rows'
    part, counted once, and the leaves' partial gradients are summed over
    the batch axes after the backward (``_sum_partial_grads``). Not split:
    every rank runs the whole batch, and its gradient is the whole
    gradient. ``embed`` is gathered once and serves both the embedding and
    the CE."""
    mesh = train.mesh
    if train.split:
        rows = sharding.batch_rows(mesh, torch.as_tensor(batch["tokens"]).shape[0])
        batch = {k: torch.as_tensor(v).narrow(_batch_axis(k), rows.start,
                                              rows.stop - rows.start)
                 for k, v in batch.items()}
    params = dict(params, **train.use({"embed": params["embed"]}, cfg))
    tot, cnt = _ce_sums(params, cfg, batch, train)
    if not train.split:
        return tot / torch.clamp(cnt, min=1.0)
    axes = sharding.batch_axes(mesh)
    cnt = mesh_util.all_reduce_sum(cnt.detach(), mesh, axes)
    return mesh_util.sum_over(tot / torch.clamp(cnt, min=1.0), mesh, axes)


def _leaf_grads(params, loss_of):
    """(loss, gradient tree) of ``loss_of(params)``; the gradients flow to
    detached views of the leaves, in the params' types (zero for a leaf
    the loss does not reach, as JAX's)."""
    leaves, spec = tree_flatten(params)
    leaves = [w.detach().requires_grad_() for w in leaves]
    with torch.enable_grad():
        loss = loss_of(tree_unflatten(leaves, spec))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(
        [torch.zeros_like(w) if g is None else g for w, g in zip(leaves, grads)], spec)


def _sum_partial_grads(grads, train: _Train):
    """A split pass's gradients completed: each leaf's partial gradient
    summed over the batch axes that do not split the leaf (one all-reduce
    a dtype and set of axes, the leaves packed flat): a leaf held whole
    over ``pod`` and ``data``; an FSDP block over ``pod`` only, since its
    gather's reduce-scatter summed it over ``data``. Not split: as they
    are."""
    if not train.split:
        return grads
    leaves, spec = tree_flatten(grads)
    specs = tree_flatten(sharding._zip_map(lambda g, sp: sp, grads, train.specs),
                         is_leaf=lambda x: isinstance(x, tuple))[0]
    batch = sharding.batch_axes(train.mesh)
    out = list(leaves)
    groups: Dict[Any, list] = {}
    for i, (g, sp) in enumerate(zip(leaves, specs)):
        axes = tuple(a for a in batch if a not in sharding.spec_axes(sp))
        if axes:
            groups.setdefault((str(g.dtype), axes), []).append(i)
    for (_, axes), idx in sorted(groups.items()):
        flat = mesh_util.all_reduce_sum(torch.cat([leaves[i].reshape(-1) for i in idx]),
                                        train.mesh, axes)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return tree_unflatten(out, spec)


def value_and_grad(params, cfg: ModelConfig, batch, mesh=None):
    """(loss, grads) of ``loss_fn`` at ``params``: the gradient tree has the
    params' structure and types (zero for a leaf the loss does not reach,
    as JAX's). ``params`` are left as they are: the gradients flow to
    detached views of them. On ``mesh`` the gradients are of this rank's
    leaves (its placement) and whole: summed over every rank that took
    part in them."""
    if mesh is None:
        return _leaf_grads(params, lambda p: loss_fn(p, cfg, batch))
    train = _train_place(cfg, mesh, batch)
    loss, grads = _leaf_grads(params, lambda p: _train_loss(p, cfg, batch, train))
    return loss, _sum_partial_grads(grads, train)


def make_train_step(cfg: ModelConfig, optimizer, microbatches: int = 1,
                    accum_dtype=torch.float32, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": ...})``, the reference's: the gradient of ``loss_fn`` by
    autograd (through the flash_attention kernels' backward on the card);
    with ``microbatches`` > 1 the batch split into that many equal parts
    (``pos3`` on its axis 1), their gradients accumulated in
    ``accum_dtype`` and the loss and gradients divided by ``microbatches``;
    then ``optimizer.update`` (``train.optim.AdamW``).

    ``mesh=`` (a (data, model) mesh of ``core.mesh.make_host_mesh``, every
    rank calling the step alike): params and optimizer state are this
    rank's placement (``sharding.train_specs`` and ``place``; AdamW's
    moments take the params'), ``batch`` the whole batch. Each microbatch
    is cut first, then each rank runs its rows of it over ``data`` where
    they divide (else the whole microbatch, as the reference's
    ``batch_spec`` replicates it); FSDP weights are gathered at their use
    and their gradients reduce-scattered, the experts split over ``model``,
    the partial gradients of the leaves held whole summed over ``data``
    once a step, after the accumulation; the update is elementwise on each
    rank's blocks with the whole tree's clip norm. The loss is the whole
    batch's on every rank."""
    m = microbatches
    specs = None if mesh is None else sharding.train_specs(cfg, param_shapes(cfg), mesh)

    def part(k: str, x, i: int):
        x = torch.as_tensor(x)
        axis = _batch_axis(k)
        n = x.shape[axis] // m
        return x.narrow(axis, i * n, n)

    def one(params, batch):
        """(loss, gradients before the sum over data, the pass's _Train)."""
        if mesh is None:
            return (*_leaf_grads(params, lambda p: loss_fn(p, cfg, batch)), None)
        train = _train_place(cfg, mesh, batch, specs)
        return (*_leaf_grads(params, lambda p: _train_loss(p, cfg, batch, train)), train)

    def grads_of(params, batch):
        if m == 1:
            loss, grads, train = one(params, batch)
            return loss, grads if train is None else _sum_partial_grads(grads, train)
        loss = 0.0
        leaves, spec = tree_flatten(params)
        acc = [torch.zeros(w.shape, dtype=accum_dtype, device=w.device) for w in leaves]
        for i in range(m):
            l, g, train = one(params, {k: part(k, v, i) for k, v in batch.items()})
            loss = loss + l
            for a, gi in zip(acc, tree_flatten(g)[0]):
                a.add_(gi.to(accum_dtype))
        grads = tree_unflatten(acc, spec)
        if train is not None:
            grads = _sum_partial_grads(grads, train)
        return loss / m, tree_map(lambda a: a.div_(m), grads)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        # the update gets the only reference to the gradients, so that it
        # frees them as soon as it has scaled them (a call that unpacks
        # ``**kwargs`` would keep them in its argument tuple)
        held = [grads]
        del grads
        params, opt_state = optimizer.update(held.pop(), opt_state, params,
                                             mesh=mesh, specs=specs)
        return params, opt_state, {"loss": loss}

    return train_step


# ===========================================================================
# serving: cache init, prefill, decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None):
    """An empty cache of ``max_len`` slots (the reference's): K/V for a GQA
    decoder; MLA's latent ``ckv`` [L,B,S,kv_lora] and rotary ``kpe``
    [L,B,S,rope]; the hybrid's conv [L,B,W-1,d_in] and SSM [L,B,H,dstate,dh]
    (float32) states beside K/V for each shared-block application; xLSTM's
    float32 mLSTM memories ``mS`` [L_m,B,H,dh,dh+1] and sLSTM states ``sh``,
    ``sc``, ``sn`` [L_s,B,D]. The encoder-decoder's also holds an encoder
    memory ``enc_h`` of ``enc_len`` frames (zero by default, as the
    reference's server leaves it)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt, f32 = _dt(cfg), torch.float32

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    kv = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.kind == "xlstm":
        n_seg, per = _xlstm_layout(cfg)
        dh = cfg.ssm_expand * cfg.d_model // cfg.n_heads
        cache = {"mS": zeros((n_seg * per, batch, cfg.n_heads, dh, dh + 1), f32)}
        cache.update({n: zeros((n_seg, batch, cfg.d_model), f32) for n in ("sh", "sc", "sn")})
    elif cfg.kind == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        cache = {"conv": zeros((cfg.n_layers, batch, cfg.conv_width - 1, d_in)),
                 "ssm": zeros((cfg.n_layers, batch, cfg.n_heads, cfg.ssm_state,
                               d_in // cfg.n_heads), f32),
                 "k": zeros((_n_attn(cfg),) + kv), "v": zeros((_n_attn(cfg),) + kv)}
    elif cfg.attn == "mla":
        m = cfg.mla
        cache = {"ckv": zeros((cfg.n_layers, batch, max_len, m.kv_lora)),
                 "kpe": zeros((cfg.n_layers, batch, max_len, m.rope_dim))}
    else:
        cache = {"k": zeros((cfg.n_layers,) + kv), "v": zeros((cfg.n_layers,) + kv)}
        if cfg.kind == "encdec":
            cache["enc_h"] = zeros((batch, enc_len, cfg.d_model))
    cache["len"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def _decode_attn(q, k_cache, v_cache, valid_len, mesh=None):
    """q: [B,H,hd]; caches [B,S,kv,hd]; valid_len: filled slots. A cache of
    no slots (an empty encoder memory) attends to nothing: the reference's
    softmax over zero keys gives zeros, and so does this, with no launch.
    On ``mesh`` the caches are this rank's block of slots (and rows), and
    ``valid_len`` counts the whole cache's."""
    b, h, hd = q.shape
    if mesh is not None:
        return L.sharded_decode_attention(q, k_cache, v_cache, valid_len, mesh)
    if k_cache.shape[1] == 0:
        return torch.zeros_like(q)
    acc, _, l = fd_ops.gqa_decode_partials(q, k_cache, v_cache, valid_len)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, h, hd).to(q.dtype)


def _latent_partials(q_c, q_pe, ckv_c, kpe_c, valid_len, offset, scale: float):
    """Unnormalized (acc, m, l) of MLA's latent attention over cache slots
    ``offset + [0, S)``, of which those below ``valid_len`` count."""
    sc = (torch.einsum("bhk,bsk->bhs", q_c, ckv_c.float())
          + torch.einsum("bhr,bsr->bhs", q_pe.float(), kpe_c.float())) * scale
    cols = torch.arange(ckv_c.shape[1], device=sc.device) + offset
    sc = torch.where(cols[None, None, :] < valid_len, sc, L.NEG)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    return torch.einsum("bhs,bsk->bhk", p, ckv_c.float()), m, p.sum(-1)


def mla_latent_attention(q_c, q_pe, ckv_c, kpe_c, valid_len, scale: float, mesh=None):
    """MLA's decode attention in the latent space, the reference's
    ``_mla_latent_attention``, in float32: q_c [B,H,kv_lora] (float32),
    q_pe [B,H,rope], caches ckv_c [B,S,kv_lora] and kpe_c [B,S,rope] of
    which the first ``valid_len`` slots count. Returns the
    attention-weighted latent [B,H,kv_lora]. On ``mesh`` the caches are
    this rank's block of slots over ``model`` (columns offset by ``rank *
    S_loc``) and of rows over ``data`` when B divides it; the partials
    merge by log-sum-exp, as the reference's ``shard_map`` does."""
    if mesh is None:
        acc, _, l = _latent_partials(q_c, q_pe, ckv_c, kpe_c, valid_len, 0, scale)
        return acc / torch.clamp(l, min=1e-30)[..., None]
    rows = sharding.batch_rows(mesh, q_c.shape[0])
    if rows is not None:
        q_c, q_pe = q_c[rows], q_pe[rows]
    offset = mesh_util.rank_of(mesh, "model") * ckv_c.shape[1]
    acc, m, l = _latent_partials(q_c, q_pe, ckv_c, kpe_c, valid_len, offset, scale)
    return L.gather_batch(L.lse_merge(acc, m, l, mesh), rows, mesh)


def _mesh_slot(clen, s_loc: int, batch: int, mesh):
    """Where a decode step on ``mesh`` writes its cache row: the reference
    writes slot ``min(len, S - 1)`` of the whole cache of S = ``s_loc *
    model`` slots, which exactly one rank over ``model`` holds. Returns
    (this rank's slot index [1], whether it holds that slot (a bool on the
    device), its rows of the batch or None)."""
    start = mesh_util.rank_of(mesh, "model") * s_loc
    g = torch.clamp(clen, max=s_loc * sharding.axis_size(mesh, "model") - 1)
    own = (g >= start) & (g < start + s_loc)
    return (torch.clamp(g - start, 0, s_loc - 1).reshape(1).long(), own,
            sharding.batch_rows(mesh, batch))


def _write_row(cache_row, row, slot) -> None:
    """``cache_row`` [B,S,...] takes ``row`` [B,1,...] at ``slot``, a [1]
    index; on a mesh (``_mesh_slot``) the rank's rows of it, and only where
    the rank holds the slot (elsewhere the slot is written back as it is)."""
    if isinstance(slot, tuple):
        slot, own, rows = slot
        row = row if rows is None else row[rows]
        row = torch.where(own, row, cache_row.index_select(1, slot))
    cache_row.index_copy_(1, slot, row)


def _gqa_decode_attn(h, blk, cfg: ModelConfig, k_cache, v_cache, slot, valid,
                     positions, mesh=None):
    """One token's self-attention (its K/V row written at ``slot`` in
    place), through the output projection."""
    b, hd = h.shape[0], cfg.hd
    q = (h @ blk["wq"]).view(b, 1, cfg.n_heads, hd)
    k = (h @ blk["wk"]).view(b, 1, cfg.n_kv_heads, hd)
    v = (h @ blk["wv"]).view(b, 1, cfg.n_kv_heads, hd)
    q, k = _rotate(q, k, cfg, positions, _pos3(cfg, positions, None))
    _write_row(k_cache, k, slot)
    _write_row(v_cache, v, slot)
    o = _decode_attn(q[:, 0], k_cache, v_cache, valid, mesh)
    return o.reshape(b, cfg.n_heads * hd) @ blk["wo"]


def _mla_decode_attn(h, blk, cfg: ModelConfig, ckv_c, kpe_c, slot, valid, positions,
                     mesh=None):
    """One token's MLA (``repro.models.lm._mla_decode``): its latent and
    rotary key rows written at ``slot`` in place, then the absorbed
    attention: q_nope through ``w_uk`` into the latent space, attention over
    the latent cache, back through ``w_uv``, all in float32."""
    m = cfg.mla
    b, H = h.shape[0], cfg.n_heads
    q = (L.rms_norm_of_product(h, blk["wq_a"], blk["q_ln"]) @ blk["wq_b"]).view(
        b, H, m.nope_dim + m.rope_dim)
    q_nope, q_pe = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_pe = L.apply_rope(q_pe[:, None], positions, cfg.rope_theta)[:, 0]
    kv = h @ blk["wkv_a"]
    ckv = L.rms_norm(kv[..., :m.kv_lora], blk["kv_ln"])
    kpe = L.apply_rope(kv[..., m.kv_lora:][:, None, None, :], positions,
                       cfg.rope_theta)[:, 0, 0]
    _write_row(ckv_c, ckv[:, None], slot)
    _write_row(kpe_c, kpe[:, None], slot)
    wkv_b = blk["wkv_b"].view(m.kv_lora, H, m.nope_dim + m.v_dim)
    w_uk, w_uv = wkv_b[..., :m.nope_dim], wkv_b[..., m.nope_dim:]
    q_c = torch.einsum("bhn,khn->bhk", q_nope.float(), w_uk.float())
    ctx = mla_latent_attention(q_c, q_pe, ckv_c, kpe_c, valid,
                               (m.nope_dim + m.rope_dim) ** -0.5, mesh)
    o = torch.einsum("bhk,khv->bhv", ctx, w_uv.float())
    return o.reshape(b, H * m.v_dim).to(h.dtype) @ blk["wo"]


def make_decode_step(cfg: ModelConfig, mesh=None):
    """Returns decode_step(params, cache, token [B], enc_h=None) -> (logits
    [B,V], cache).

    The new K/V (or MLA latent) row goes to slot ``min(len, max_len - 1)``:
    JAX's ``dynamic_update_slice`` clamps its start the same way, and the
    attention then counts ``len + 1`` filled slots, as the JAX package does
    (all of them once ``len`` has passed ``max_len``). The recurrent states
    (the hybrid's conv and SSM states, xLSTM's memories) are overwritten in
    place with the step's. The encoder-decoder's cross-attention reads
    ``enc_h``, by default the cache's, and recomputes its K and V every
    step, as the reference does.

    On ``mesh`` (GQA and MLA decoders, the hybrid) ``params`` and ``cache``
    are this rank's (``models.sharding``): the row goes to the rank that
    holds the slot, attention runs over each rank's slots and merges, and
    the MoE splits its experts. The encoder-decoder and xLSTM ignore
    ``mesh``, as the reference's do."""
    check_supported(cfg)
    hd = cfg.hd
    mesh = mesh if sharding.sharded_cache(cfg) else None

    def decoder(x, params, cache, slot, valid, positions, enc_h):
        blocks, cross = params["blocks"], params.get("cross")
        rows = [cache[n] for n in _cache_rows(cfg)]
        layers = _layers(blocks)
        xlayers = _layers(cross) if cross is not None else None
        for i, blk in enumerate(layers):
            h = L.rms_norm(x, blk["ln1"])
            attn = _mla_decode_attn if cfg.attn == "mla" else _gqa_decode_attn
            a = attn(h, blk, cfg, rows[0][i], rows[1][i], slot, valid, positions, mesh)
            if cross is not None:
                xblk = xlayers[i]
                x, h = L.add_rms_norm(x, a, xblk["ln_x"])
                b = x.shape[0]
                q = (h @ xblk["xq"]).view(b, cfg.n_heads, hd)
                ke = (enc_h @ xblk["xk"]).view(b, -1, cfg.n_kv_heads, hd)
                ve = (enc_h @ xblk["xv"]).view(b, -1, cfg.n_kv_heads, hd)
                o = _decode_attn(q, ke, ve, ke.shape[1])
                a = o.reshape(b, cfg.n_heads * hd) @ xblk["xo"]
            x, h = L.add_rms_norm(x, a, blk["ln2"])
            x = x + _ffn(h, blk, cfg, mesh)
        return x, None

    def hybrid(x, params, cache, slot, valid, positions):
        mp, sh = params["mamba"], params["shared_attn"]
        layers = _layers(mp)
        n = len(layers)
        last = torch.zeros_like(x)
        for i, blk in enumerate(layers):
            x = x + last
            out, (conv_s, ssm_s) = ssm.mamba2_forward(
                L.rms_norm(x, blk["ln"])[:, None], blk, cfg,
                state=(cache["conv"][i], cache["ssm"][i]), decode=True)
            cache["conv"][i].copy_(conv_s)
            cache["ssm"][i].copy_(ssm_s)
            last = out[:, 0]
            if (i + 1) % cfg.attn_every == 0 or i + 1 == n:
                ai = i // cfg.attn_every
                x = x + last
                a = _gqa_decode_attn(L.rms_norm(x, sh["ln1"]), sh, cfg, cache["k"][ai],
                                     cache["v"][ai], slot, valid, positions, mesh)
                x, h = L.add_rms_norm(x, a, sh["ln2"])
                last = L.mlp(h, sh["w_gate"], sh["w_in"], sh["w_out"], "swiglu")
        return x, last

    def xlstm(x, params, cache):
        n_seg, per = _xlstm_layout(cfg)
        mlstm, slstm = _layers(params["mlstm"]), _layers(params["slstm"])
        last = torch.zeros_like(x)
        for si in range(n_seg):
            for li in range(si * per, (si + 1) * per):
                x = x + last
                blk = mlstm[li]
                out, (S,) = ssm.mlstm_forward(L.rms_norm(x, blk["ln"])[:, None], blk, cfg,
                                              state=(cache["mS"][li],), decode=True)
                cache["mS"][li].copy_(S)
                last = out[:, 0]
            x = x + last
            sl = slstm[si]
            names = ("sh", "sc", "sn")
            # the reference casts the norm's output to float32 for the gates;
            # XLA computes its last op, the product with ``ln``, in float32
            xn = L.rms_norm(x, torch.ones_like(sl["ln"])).float() * sl["ln"].float()
            out, state = ssm.slstm_forward(xn[:, None], sl, cfg,
                                           state=tuple(cache[n][si] for n in names),
                                           decode=True)
            for n, t in zip(names, state):
                cache[n][si].copy_(t)
            last = out[:, 0]
        return x, last

    def decode_step(params, cache, token, enc_h=None):
        x = _embed(params, cfg, token)  # [B, D]
        dev = x.device
        clen = torch.as_tensor(cache["len"], dtype=torch.int32, device=dev)
        positions = clen.reshape(1, 1).expand(x.shape[0], 1)
        valid = clen + 1
        if cfg.kind == "xlstm":
            x, last = xlstm(x, params, cache)
        else:
            rows = cache["k"] if cfg.kind == "hybrid" else cache[_cache_rows(cfg)[0]]
            slot = (torch.clamp(clen, max=rows.shape[2] - 1).reshape(1).long()
                    if mesh is None else _mesh_slot(clen, rows.shape[2], x.shape[0], mesh))
            if cfg.kind == "hybrid":
                x, last = hybrid(x, params, cache, slot, valid, positions)
            else:
                x, last = decoder(x, params, cache, slot, valid, positions,
                                  cache.get("enc_h") if enc_h is None else enc_h)
        logits = _logits(params, _final_norm(params, x, last))
        cols = torch.arange(cfg.padded_vocab, device=dev)
        logits = torch.where(cols[None, :] < cfg.vocab, logits, L.NEG)
        return logits, dict(cache, len=valid)

    return decode_step


# ===========================================================================
# prefill: process a prompt, return (last-token logits, populated cache)
# ===========================================================================

def prefill(params, cfg: ModelConfig, tokens, max_len: int, enc_embeds=None,
            pos3=None, mesh=None):
    """Logits of the last token (no vocab mask, as in the JAX package) and
    a cache of ``max_len`` slots holding the prompt's rows (K/V, MLA's
    latent rows, the hybrid's K/V and states, xLSTM's memories; for the
    encoder-decoder also the encoder's memory of ``enc_embeds``). On
    ``mesh`` the MoE splits its experts (``params`` are this rank's) and
    the cache returned is this rank's (``sharding.shard_cache``)."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens exceeds max_len {max_len}")
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    enc_h = None
    if cfg.kind == "encdec":
        enc_h = cache["enc_h"] = encode(params, cfg, enc_embeds)
    x, last = _body(params, cfg, x, positions, pos3, enc_h, cache, mesh)
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    cache = sharding.shard_cache(cache, cfg, mesh)
    if last is not None:  # the last token's slice keeps XLA from fusing the add
        x = x + last
    return _logits(params, _final_norm(params, x[:, -1])), cache
