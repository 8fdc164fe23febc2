"""The program's federated LM family (``core.families.lm_family``) on a
``configs`` architecture with the configuration file's sizes, and the
token federation's engine hooks."""
from __future__ import annotations

from bench import counts

UNIT = "tokens"
EVAL_IS_ACCURACY = False    # evaluation is minus the LM loss: relative gaps
# the configuration file's keys that are ModelConfig fields
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "norm_type", "rope_theta",
              "tie_embeddings", "dtype", "attn_impl")


def model_config(cfg: dict):
    from repro_torch.configs import get_config
    return get_config(cfg["arch"]).replace(
        **{k: cfg[k] for k in MODEL_KEYS})


def family(cfg: dict):
    from repro_torch.core.families import lm_family
    return lm_family(model_config(cfg), cfg["alpha"])


def classes(cfg: dict) -> int:
    return model_config(cfg).padded_vocab


def engine_base(srv):
    """The engine's documented hooks for token-only data: the KD hard label
    is a window's last token, and evaluation is minus the LM loss."""
    import torch

    class TokenFedRAC(srv.FedRAC):
        def _batch_from_gathered(self, g):
            return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

        def evaluate(self, level, params, test):
            test = self._to_device(test)
            with torch.no_grad():
                loss, _ = self.family.loss_and_logits(level, params, test)
            return -float(loss)

    return TokenFedRAC


def units_per_sample(traffic: dict) -> int:
    return traffic["seq"]


def flops_per_call(cfg: dict, traffic: dict, members: dict,
                   n_test: int) -> float:
    """Model FLOPs of a ``train()`` call (``counts.call_flops``) for dense
    decoder blocks.  The head counts at the positions its loss reads: all
    but the last under CE, the last under KD; the teacher's and the KD
    student's head at the last one."""
    S = traffic["seq"]
    return counts.call_flops(traffic, members, n_test, lambda level, kd: (
        counts.lm_train(cfg, level, S, 1 if kd else S - 1),
        counts.lm_forward(cfg, 0, S, 1),
        counts.lm_forward(cfg, level, S, S - 1)))
