"""Assigned-architecture configs, copied from ``repro.configs`` (``--arch <id>``).

Each module exposes ``config()`` (the exact assigned full-scale config) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
from repro_torch.configs import (deepseek_67b, deepseek_v2_236b,
                                 granite_3_2b, granite_moe_1b_a400m,
                                 nemotron_4_15b, qwen2_vl_72b,
                                 seamless_m4t_medium, stablelm_12b,
                                 xlstm_1_3b, zamba2_1_2b)

ARCHS = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "deepseek-v2-236b": deepseek_v2_236b,
    "xlstm-1.3b": xlstm_1_3b,
    "nemotron-4-15b": nemotron_4_15b,
    "stablelm-12b": stablelm_12b,
    "granite-3-2b": granite_3_2b,
    "deepseek-67b": deepseek_67b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "zamba2-1.2b": zamba2_1_2b,
    "qwen2-vl-72b": qwen2_vl_72b,
}


def get_config(arch: str):
    return ARCHS[arch].config()


def get_smoke_config(arch: str):
    return ARCHS[arch].smoke_config()
