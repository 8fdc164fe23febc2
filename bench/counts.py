"""The yardstick's arithmetic: the chip's peaks, a kernel's bound, and the
model FLOPs a ``FedRAC.train()`` call needs, all from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at
its 700 W limit.  A bound counts each input byte read once and each
output byte written once, and the operations these inputs need; the
least time is the larger of bytes over the memory rate and operations
over the tensor-core peak.  The FLOP counts are the work the objective
needs, not what the program happens to run: padded member rows,
recomputation and unread logits are left out (``call_flops``, with a
sample's count from the kind's ``flops_per_call`` in ``bench/kinds/``).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor cores: the fastest
#                                fp32-accurate rate, so no correct run
#                                of an fp32 configuration reads above it
FP32_BYTES = 4


def bound_ms(nbytes: float, ops: float):
    """(least milliseconds, "bytes" | "operations"): the larger of the
    two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / TF32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_pairs(S: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one row of heads."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else S
        total += hi - lo
    return total


def fedagg_work(C: int, D: int):
    """(bytes, operations) of ``out[d] = sum_c w[c] * plane[c, d]``: the
    (C, D) plane and C weights read once, D outputs written once; one
    multiply and one add per plane element."""
    return (C * D + C + D) * FP32_BYTES, 2 * C * D


def flash_work(bh: int, bkv: int, S: int, hd: int, elt: int, causal: bool,
               window: int):
    """(bytes, operations) of one forward call: q and o of (bh, S, hd), k
    and v of (bkv, S, hd) each moved once; QK^T and PV are 2 operations
    per unmasked pair and head dimension each."""
    nbytes = (2 * bh + 2 * bkv) * S * hd * elt
    ops = 4 * attn_pairs(S, causal, window) * hd * bh
    return nbytes, ops


# ------------------------------------------------------------ the CNN
def cnn_widths(cfg: dict, level: int):
    s = cfg["base_width"] * cfg["alpha"] ** level
    return [max(4, int(round(f * s))) for f in cfg["base_filters"]]


def cnn_layer_flops(cfg: dict, level: int):
    """Forward FLOPs per sample of each layer: a 3x3 SAME convolution is
    2 * 9 * cin * cout per output pixel; a 2x2/2 pool follows every odd
    convolution while both sides are >= 2 (14 -> 7 -> 3); the head is
    2 * cin * classes.  ReLU, pooling and the mean are not counted."""
    hw, cin, out = cfg["image_hw"], cfg["in_channels"], []
    for i, f in enumerate(cnn_widths(cfg, level)):
        out.append(2 * 9 * cin * f * hw * hw)
        cin = f
        if i % 2 == 1 and hw >= 2:
            hw //= 2
    out.append(2 * cin * cfg["classes"])
    return out


def cnn_forward(cfg: dict, level: int) -> float:
    return float(sum(cnn_layer_flops(cfg, level)))


def cnn_train(cfg: dict, level: int) -> float:
    """Forward, input gradient and weight gradient (each the forward's
    cost) of every layer, except the first layer's input gradient: the
    images take none."""
    layers = cnn_layer_flops(cfg, level)
    return 3.0 * sum(layers) - layers[0]


# ------------------------------------------------------------ the LM
def lm_d_ff(cfg: dict, level: int) -> int:
    """The FFN width of cluster level ``level``: d_ff * alpha**level,
    rounded to a multiple of 128 (16 below 256), as the FL family
    compresses it."""
    if level == 0:
        return cfg["d_ff"]
    x = int(cfg["d_ff"] * cfg["alpha"] ** level)
    mult = 128 if x >= 256 else 16
    return max(mult, int(round(x / mult)) * mult)


def lm_block_params(cfg: dict, level: int) -> int:
    """Matrix parameters of the decoder blocks: wq, wk, wv, wo and the
    gated MLP's three matrices, per layer (the norms carry none)."""
    d = cfg["d_model"]
    q = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv_heads"] * cfg["head_dim"]
    return cfg["n_layers"] * (2 * d * q + 2 * d * kv
                              + 3 * d * lm_d_ff(cfg, level))


def lm_forward(cfg: dict, level: int, S: int, head_positions: int) -> float:
    """Forward FLOPs of one sequence: 2 per block parameter and token, 4 *
    head_dim per unmasked pair and head in each layer, and the head's
    2 * d * vocab at the positions whose logits the loss reads."""
    attn = cfg["n_layers"] * 4 * attn_pairs(S, True, 0) * cfg["head_dim"] \
        * cfg["n_heads"]
    head = 2 * cfg["d_model"] * cfg["vocab_size"] * head_positions
    return 2.0 * lm_block_params(cfg, level) * S + attn + head


def lm_train(cfg: dict, level: int, S: int, head_positions: int) -> float:
    """Forward and backward (twice the forward) of one sequence."""
    return 3.0 * lm_forward(cfg, level, S, head_positions)


def call_flops(traffic: dict, members: dict, n_test: int,
               level_flops) -> float:
    """Model FLOPs one ``FedRAC.train()`` call needs: every real member's
    local steps (``members``: level -> member count), the master's
    forward as teacher for each KD member batch, and one evaluation of
    the test set per round and trained level.  ``level_flops(level, kd)``
    is the kind's count of one sample at ``level``: (a training step, the
    master's forward as its teacher, an evaluation); each kind's
    ``flops_per_call`` (``bench/kinds/``) gives it."""
    fl = traffic["fl"]
    per_member = fl["rounds"] * fl["steps_per_round"] * fl["local_batch"]
    total = 0.0
    for level, n in members.items():
        if n == 0:
            continue
        kd = fl["use_kd"] and level > 0
        step, teacher, evaluation = level_flops(level, kd)
        total += n * per_member * (step + (teacher if kd else 0.0))
        total += fl["rounds"] * n_test * evaluation
    return total
