"""Cell builders for the dry run: (arch x input shape x mesh) -> this
rank's inputs as ``meta`` tensors (nothing allocated) and the step
function. The port of ``repro.launch.specs``, with its shapes, microbatch
counts, applicability notes and branches.

Shapes (the reference's):
  train_4k    — seq 4096,  global batch 256  (train_step)
  prefill_32k — seq 32768, batch 32          (prefill -> logits + cache)
  decode_32k  — cache 32768, batch 128       (decode_step, one token)
  long_500k   — cache 524288, batch 1        (decode_step; sub-quadratic or
                compressed-latent archs only; skips documented in dryrun)

Every leaf is this rank's block under the placement the port's step runs
with, which is not the reference's GSPMD placement: training keeps
``sharding.train_specs`` (FSDP blocks over ``data``, experts over
``model``, everything else whole), prefill and decode
``sharding.serve_specs`` (experts over ``model``) and
``sharding.serve_cache_specs`` (K/V over the batch axes and ``model``).
The port's entry points take the whole batch on every rank, so the token
inputs are whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import lm, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import AdamW

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

# the reference's microbatch counts (chosen there so activations fit 16 GB)
MICROBATCHES = {
    "granite-moe-1b-a400m": 2, "deepseek-v2-236b": 32, "xlstm-1.3b": 4,
    "nemotron-4-15b": 8, "stablelm-12b": 8, "granite-3-2b": 2,
    "deepseek-67b": 16, "seamless-m4t-medium": 2, "zamba2-1.2b": 4,
    "qwen2-vl-72b": 16,
}


def long_context_applicability(cfg: ModelConfig) -> Tuple[bool, str]:
    if cfg.subquadratic:
        return True, "sub-quadratic (SSM/hybrid) — constant or S-sharded state"
    if cfg.attn == "mla":
        return True, ("beyond-spec extra: MLA's compressed latent cache makes "
                      "a 500k context practical")
    return False, ("skipped: pure full-attention arch — a 500k dense-KV decode "
                   "presupposes an infeasible 500k quadratic prefill "
                   "(DESIGN.md Sec. 5 shape policy)")


def _abs(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_model_state(cfg: ModelConfig, mesh, with_opt: bool, opt=None):
    """(params, AdamW state or None, specs): this rank's blocks as meta
    tensors, under the training placement with the optimizer state, else
    under the serving one."""
    shapes = lm.param_shapes(cfg)
    specs = (sharding.train_specs if with_opt else sharding.serve_specs)(cfg, shapes, mesh)
    params = sharding.to_shape_dtype(lm.abstract_params(cfg), mesh, specs)
    if not with_opt:
        return params, None, specs
    return params, (opt or AdamW()).init(params), specs


@dataclasses.dataclass
class Cell:
    fn: Callable
    args: Tuple
    static_descr: str


def _extras(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.kind == "encdec":
        out["enc_embeds"] = _abs((batch, seq, cfg.d_model), torch.bfloat16)
    if cfg.attn == "mrope":
        out["pos3"] = _abs((3, batch, seq), torch.int32)
    return out


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               microbatches: Optional[int] = None) -> Cell:
    info = SHAPES[shape_name]
    seq, batch = info["seq"], info["batch"]

    if info["kind"] == "train":
        # bf16 optimizer moments for the 100B+ models (the reference's)
        moment_dtype = "bfloat16" if cfg.param_count() > 1e11 else "float32"
        opt = AdamW(moment_dtype=moment_dtype)
        params, opt_state, _ = abstract_model_state(cfg, mesh, True, opt=opt)
        mb = microbatches or MICROBATCHES.get(cfg.name, 4)
        step = lm.make_train_step(cfg, opt, microbatches=mb, mesh=mesh)
        batch_args: Dict[str, Any] = {"tokens": _abs((batch, seq), torch.int32),
                                      "labels": _abs((batch, seq), torch.int32)}
        batch_args.update(_extras(cfg, batch, seq))
        return Cell(fn=step, args=(params, opt_state, batch_args),
                    static_descr=f"train mb={mb}")

    if info["kind"] == "prefill":
        # serving without FSDP when the params fit one model-parallel group
        # (the reference's; deepseek-v2's 236B params keep it)
        if cfg.param_count() * 2 / sharding.axis_size(mesh, "model") < 10e9:
            cfg = dataclasses.replace(cfg, fsdp=False)
        params, _, _ = abstract_model_state(cfg, mesh, False)
        tokens = _abs((batch, seq), torch.int32)
        extra = _extras(cfg, batch, seq)
        names = list(extra)

        def step(params, tokens, *extras):
            kw = dict(zip(names, extras))
            return lm.prefill(params, cfg, tokens, max_len=seq, mesh=mesh, **kw)

        return Cell(fn=step, args=(params, tokens) + tuple(extra.values()),
                    static_descr="prefill")

    # decode: the param placement as it is, the cache's rows and slots split
    params, _, _ = abstract_model_state(cfg, mesh, False)
    whole = lm.init_cache(cfg, batch, seq, enc_len=min(seq, 4096) if cfg.kind == "encdec"
                          else 0, device="meta")
    cache = sharding.to_shape_dtype(whole, mesh,
                                    sharding.serve_cache_specs(cfg, whole, mesh, batch))
    token = _abs((batch,), torch.int32)
    step = lm.make_decode_step(cfg, mesh=mesh)
    return Cell(fn=step, args=(params, cache, token), static_descr="decode")
