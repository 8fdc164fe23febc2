"""The program's federated LM family (``core.families.lm_family``) on a
``configs`` architecture with the configuration file's sizes, and the
token federation's engine hooks."""
from __future__ import annotations

UNIT = "tokens"
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
