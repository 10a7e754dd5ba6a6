"""Run-time configuration: the cache-or-JIT low-degree-extension decision.

Mirrors the reference's config system (triton-vm/src/config.rs:24-94):
whether the prover materializes the committed codewords (CACHE) or
recomputes them coset by coset (JIT). The budget is the memory of the
device the prover runs on: on a card the memory `torch.cuda.mem_get_info`
reports free plus what PyTorch's caching allocator holds unused, on the
CPU the free host memory.

Decision inputs, in precedence order (config.rs:60-94):
  1. programmatic override via `overwrite_lde_trace_caching_to(...)`.
  2. heuristic: cache iff the committed main+aux+quotient codewords fit
     in a fraction of the device's free memory.
"""

from __future__ import annotations

import os
from enum import Enum

import torch


class CacheDecision(Enum):
    CACHE = "cache"
    JIT = "jit"


_override: CacheDecision | None = None

# Committed-codeword bytes per LDT-domain row: 379 main BFEs (8 B each),
# 91 aux XFEs (24 B) and 5 quotient-segment XFEs.
_BYTES_PER_LDT_ROW = 379 * 8 + 91 * 24 + 5 * 24

# Use at most this fraction of device memory for cached codewords; the
# prover also needs working space for NTTs, hashes, and quotients.
_MEM_FRACTION = 0.4


def overwrite_lde_trace_caching_to(decision: CacheDecision | None) -> None:
    """Programmatic analog of config.rs `overwrite_lde_trace_caching_to`."""
    global _override
    _override = decision


def _device_memory_bytes(device) -> int:
    """Free memory of `device` in bytes. On a card that counts the blocks
    PyTorch's caching allocator holds but does not use (the counterpart
    of the JAX package's bytes_limit - bytes_in_use): `mem_get_info` sees
    them as taken, so after an earlier proof it reads tens of GB low."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free + (torch.cuda.memory_reserved(device)
                       - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")


def cache_lde_trace(ldt_domain_len: int, device) -> CacheDecision:
    """CACHE or JIT for an LDT domain of `ldt_domain_len` rows on
    `device`: programmatic override first, then the memory heuristic
    (config.rs:60-94)."""
    if _override is not None:
        return _override
    needed = ldt_domain_len * _BYTES_PER_LDT_ROW
    budget = _device_memory_bytes(device) * _MEM_FRACTION
    return CacheDecision.CACHE if needed <= budget else CacheDecision.JIT
