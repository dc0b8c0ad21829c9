"""Shared kernel utilities (port of the reference `repro/kernels/common.py`;
its `default_interpret` is a Pallas-on-TPU switch and has no counterpart)."""
from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b
