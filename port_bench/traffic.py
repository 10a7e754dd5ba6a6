"""The one generator of the benchmark's work, driven by a traffic file.

A run is a closed loop of prover jobs: one proof at a time, each step a
prove of the configuration's program at the traffic's padded height
followed by a verify of that proof. traffic/<name>.json holds

  log2_padded_height  the padded height the configuration's inputs for
                      this mix pad to
  ldt                 "fri" or "stir": the low-degree test the Stark picks
                      at that height (checked before the window)
  lde                 "cached" or "jit": the port's cache-or-JIT decision
                      at that height (checked before the window)
  warmup_steps        steps run before the window, counted in set-up

Every step gets its own 32-byte prover seed, derived from --seed and the
step's index, so a run's work is a fixed function of its seed.
"""

from __future__ import annotations

import hashlib


def step_seed(seed: int, index: int) -> bytes:
    """The prover seed of window step `index` of a run with `seed`."""
    return hashlib.sha256(f"port_bench step {seed} {index}".encode()).digest()


def warmup_seed(seed: int, index: int) -> bytes:
    return hashlib.sha256(
        f"port_bench warmup {seed} {index}".encode()).digest()

