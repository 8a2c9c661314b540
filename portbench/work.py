"""Operations and bytes that the inputs need: the work counts of the
kernels' roofline shares and of the model's MFU.

Counts come from the inputs, never from what a launch happens to compute:
the grouped matmul's rows are the assignments the router keeps (not the
capacity-padded rows), causal attention counts the causal half and the
prefill's head counts the one position whose logits are returned.  So
a change that skips padding raises a share without ever pushing it
past 100%.
"""

from __future__ import annotations

from .peaks import BF16_FLOPS, HBM_BYTES, bound_seconds

BF16 = 2


def gmm_products(kept: int, D: int, F: int, E: int):
    """(flops, bytes) of each grouped product of one expert FFN call
    (SwiGLU: ``w1``, ``w3``: D -> F; ``w2``: F -> D) over ``kept`` routed
    rows of ``E`` experts held here."""
    return [(2.0 * kept * K * N, (kept * K + kept * N + E * K * N) * BF16)
            for K, N in ((D, F), (D, F), (F, D))]


def gmm_bound_s(kept: int, D: int, F: int, E: int) -> float:
    return sum(bound_seconds(f, b) for f, b in gmm_products(kept, D, F, E))


def causal_pairs(S: int) -> float:
    return S * (S + 1) / 2.0


def reorder_bound_s(n_bytes: float) -> float:
    """A reorder pass reads each input byte once and writes each output
    byte once: ``n_bytes`` counts both."""
    return n_bytes / HBM_BYTES


def forward_flops(model: dict, B: int, S: int, kept: int,
                  head_positions: int) -> float:
    """Model FLOPs of one forward over ``B`` rows of ``S`` tokens of the
    attention + MoE decoder of ``model`` (a configuration's ``model``
    dict): every layer's projections, router and causal attention, the
    ``kept`` expert rows summed over the layers (three products each),
    and the head over ``head_positions`` positions of each row."""
    D, L = model["d_model"], model["n_layers"]
    Hq, Hkv = model["n_heads"], model["n_kv_heads"]
    Dh = model.get("head_dim") or D // Hq
    F, E, V = model["d_ff"], model["n_experts"], model["vocab"]
    N = B * S
    proj = 2.0 * N * D * Dh * (2 * Hq + 2 * Hkv)
    router = 2.0 * N * D * E
    attn = 4.0 * B * Hq * causal_pairs(S) * Dh
    experts = 2.0 * kept * 3 * D * F
    head = 2.0 * B * head_positions * D * V
    return L * (proj + router + attn) + experts + head


def mfu(flops: float, seconds: float) -> float:
    """Share (%) of the bf16 peak."""
    return 100.0 * flops / (seconds * BF16_FLOPS)
