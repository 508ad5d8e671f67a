"""Device-level model of MTJ write-logic (paper Fig. 1, from [16]).

A SOT-MRAM cell stores bit ``B_i`` as its resistance state. A logic op is
performed *during the write process* of the proposed 1T-1R cell (paper §3.1):

  * ``A`` — the voltage applied on RBL: logic 1 = V_b (600 mV), logic 0 = 0 V.
    V_b raises/lowers the critical switching current of the MTJ, i.e. it
    *gates* whether the write current can flip the device.
  * ``C`` — the direction of the write current between WBL and SL:
    C=1 drives toward the high-resistance (logic 1) state, C=0 toward low.
  * ``B_{i+1}`` — the resulting stored bit.

Truth behaviour (Fig. 1):
  AND (C=0, current toward 0-state, V_b *blocks* switching):
      A=1 -> blocked, keep B_i ; A=0 -> switch to 0.      B' = A AND B_i
  OR  (C=1, current toward 1-state, V_b *enables* switching):
      A=1 -> switch to 1 ; A=0 -> below threshold, keep.  B' = A OR B_i
  XOR (bipolar write: current direction follows stored state so that a
      matching input toggles; realized in [16] with a two-phase write):
      A=1 -> toggle B_i ; A=0 -> keep.                    B' = A XOR B_i

These single-cell semantics are exactly what ``fulladder.py`` composes into
the paper's 4-step FA. Everything operates on arrays of {0,1} (any integer
dtype); row-parallelism of the subarray = vectorization over the array.

The port of the reference's ``repro/core/logic.py`` (jnp) to torch: each
function takes Python ints, numpy arrays or tensors and returns a tensor
(``np.asarray`` of it is the numpy array, as the subarray simulator
reads it).
"""

from __future__ import annotations

import torch

# Physical gating model, used only to document/verify the electrical story:
# the write current I through the device must exceed the (voltage-dependent)
# critical current Ic(A) to switch. V_b on RBL raises Ic above the write
# current for the polarities used by AND/OR, and enables the toggling path
# for XOR. We verify that the truth tables below are consistent with the
# threshold story in tests/test_torch_fp_procedures.py.


def mtj_and(a, b_i):
    """B' = A AND B_i  (write toward 0, V_b blocks the switch)."""
    a = torch.as_tensor(a)
    b_i = torch.as_tensor(b_i)
    # A=0 -> write current exceeds Ic, cell resets to 0; A=1 -> V_b raises Ic,
    # switch blocked, B_i kept. Equivalent to the AND truth table:
    return torch.where(a == 0, torch.zeros_like(b_i), b_i)


def mtj_or(a, b_i):
    """B' = A OR B_i  (write toward 1, V_b enables the switch)."""
    a = torch.as_tensor(a)
    b_i = torch.as_tensor(b_i)
    return a | b_i


def mtj_xor(a, b_i):
    """B' = A XOR B_i (two-phase bipolar write toggles on A=1)."""
    a = torch.as_tensor(a)
    b_i = torch.as_tensor(b_i)
    return a ^ b_i


def mtj_write(a, b_i, mode: str):
    """Dispatch a single MTJ write-logic step.

    Args:
      a: applied RBL voltage as logic {0,1} array.
      b_i: current stored resistance state {0,1} array.
      mode: 'and' | 'or' | 'xor' | 'store' (plain data write of ``a``).
    Returns:
      B_{i+1} array.
    """
    if mode == "and":
        return mtj_and(a, b_i)
    if mode == "or":
        return mtj_or(a, b_i)
    if mode == "xor":
        return mtj_xor(a, b_i)
    if mode == "store":
        b_i = torch.as_tensor(b_i)
        return torch.broadcast_to(torch.as_tensor(a), b_i.shape).to(b_i.dtype)
    raise ValueError(f"unknown MTJ write mode: {mode}")
