"""The program's federated LM family (``core.families.lm_family``) on a
sparse-expert architecture: the LM kind's engine hooks, the configuration
file's MoE keys and µP multipliers, and model FLOPs that count the routed
experts only.  ``grouped_gemm_launches`` is the benchmark's count of the
work of the program's grouped GEMM kernel in a ``train()`` call."""
from __future__ import annotations

from bench import counts
from bench.kinds import lm

UNIT = lm.UNIT
EVAL_IS_ACCURACY = lm.EVAL_IS_ACCURACY
# the configuration file's keys that are ModelConfig fields
MODEL_KEYS = lm.MODEL_KEYS + (
    "n_experts", "experts_per_tok", "moe_impl", "router_aux_coef",
    "embed_scale", "residual_scale", "logit_scale", "attn_scale")
engine_base = lm.engine_base
units_per_sample = lm.units_per_sample


def model_config(cfg: dict):
    from repro_torch.configs import get_config
    return get_config(cfg["arch"]).replace(
        **{k: cfg[k] for k in MODEL_KEYS})


def family(cfg: dict):
    from repro_torch.core.families import lm_family
    return lm_family(model_config(cfg), cfg["alpha"])


def classes(cfg: dict) -> int:
    return model_config(cfg).padded_vocab


def n_experts(cfg: dict, level: int) -> int:
    """The experts of cluster level ``level``: n_experts * alpha**level,
    rounded, and never fewer than experts_per_tok, as the FL family
    compresses them; their width is ``counts.lm_d_ff``."""
    return max(cfg["experts_per_tok"],
               int(round(cfg["n_experts"] * cfg["alpha"] ** level)))


def moe_forward(cfg: dict, level: int, S: int, head_positions: int) -> float:
    """Forward FLOPs of one sequence: per layer 2 per attention matrix
    parameter and token, 4 * head_dim per unmasked pair and head, the
    router's 2 * d * E, and the gated MLP's 2 * 3 * d * f of each of the
    experts_per_tok experts a token is routed to (not of all E); the head's
    2 * d * vocab at the positions whose logits the loss reads."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    per_token = (2 * d * q + 2 * d * kv + d * n_experts(cfg, level)
                 + cfg["experts_per_tok"] * 3 * d * counts.lm_d_ff(cfg, level))
    attn = 4 * counts.attn_pairs(S, True, 0) * hd * cfg["n_heads"]
    head = 2 * d * cfg["vocab_size"] * head_positions
    return cfg["n_layers"] * (2.0 * per_token * S + attn) + head


def flops_per_call(cfg: dict, traffic: dict, members: dict,
                   n_test: int) -> float:
    """Model FLOPs of a ``train()`` call (``counts.call_flops``): a training
    step is three forwards; the head counts as the LM kind's does."""
    S = traffic["seq"]
    return counts.call_flops(traffic, members, n_test, lambda level, kd: (
        3.0 * moe_forward(cfg, level, S, 1 if kd else S - 1),
        moe_forward(cfg, 0, S, 1),
        moe_forward(cfg, level, S, S - 1)))


def rows_work(M: int, k: int, n: int, G: int):
    """(bytes, operations) of a rows launch: x (M, k) times G matrices
    (k, n) -> (M, n)."""
    return 4 * (M * k + G * k * n + M * n) + 8 * (G + 1), 2 * M * k * n


def wgrad_work(M: int, k: int, n: int, G: int):
    """(bytes, operations) of a weight-gradient launch: x (M, k) and dY
    (M, n) -> G matrices (k, n)."""
    return 4 * (M * k + M * n + G * k * n) + 8 * (G + 1), 2 * M * k * n


def grouped_gemm_launches(cfg: dict, traffic: dict, capacity: dict,
                          n_test: int) -> list:
    """The grouped GEMM launches of a ``train()`` call, as [(launches,
    bytes, operations)] of each kind of launch, each launch's bytes its
    inputs read once and its output written once (offsets included) and
    its operations 2 per multiply-add.  ``capacity``: level -> the rows of
    the cluster's vmapped update (its members padded to capacity), which
    the kernels run whatever the padding.

    Per MoE layer, a member step folds the capacity's members into one
    launch per product: its M = capacity * batch * seq * experts_per_tok
    routed rows in capacity * E groups (E, f at the level).  The forward
    runs three (x W_gate, x W_up: d -> f; h W_down: f -> d), the backward
    three of rows (each product's dX, on the transposed matrices) and
    three of weight gradients (each group's rows reduced: dW).  A KD
    level's round runs the master's forward (E, f at level 0) once over
    its members' batches of the round's steps; every round evaluates each
    level once on the n_test windows, a forward."""
    fl, S = traffic["fl"], traffic["seq"]
    K, d, L = cfg["experts_per_tok"], cfg["d_model"], cfg["n_layers"]
    B, R, steps = fl["local_batch"], fl["rounds"], fl["steps_per_round"]
    out = []

    def forward(times, M, E, f, G):
        out.append((2 * times * L, *rows_work(M, d, f, G)))   # gate, up
        out.append((times * L, *rows_work(M, f, d, G)))       # down

    for level, c in sorted(capacity.items()):
        E, f = n_experts(cfg, level), counts.lm_d_ff(cfg, level)
        M, G, n_steps = c * B * S * K, c * E, R * steps
        forward(n_steps, M, E, f, G)
        # dX of gate and up, of down; dW of gate and up, of down
        out.append((2 * n_steps * L, *rows_work(M, f, d, G)))
        out.append((n_steps * L, *rows_work(M, d, f, G)))
        out.append((2 * n_steps * L, *wgrad_work(M, d, f, G)))
        out.append((n_steps * L, *wgrad_work(M, f, d, G)))
        if fl["use_kd"] and level > 0:
            E0, f0 = n_experts(cfg, 0), counts.lm_d_ff(cfg, 0)
            forward(R, c * steps * B * S * K, E0, f0, E0)
        forward(R, n_test * S * K, E, f, E)
    return out
