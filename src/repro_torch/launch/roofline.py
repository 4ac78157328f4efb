"""Roofline terms of the dry run (port of the analytic parts of
``src/repro/launch/roofline.py``).

Two terms per (arch x shape x mesh), in seconds a step per device:

  compute = FLOPs / PEAK_FLOPS
  memory  = HBM bytes / HBM_BW

The constants are the NVIDIA H100 SXM's datasheet figures (989e12 dense
bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3), the card the port
runs on, at its 700 W power limit; they are datasheet numbers, not
measurements.  The reference's third term, collective bytes over the ICI
link rate, is parsed from XLA's compiled HLO (``parse_collectives``,
``terms_from_compiled``), which has no torch counterpart: the port
reports ``coll_bytes`` and ``t_collective`` as None, and its
``bottleneck`` is taken over compute and memory only.

FLOPs: the analytic MODEL_FLOPS (6 N D for training, 2 N D for inference,
N the active parameters, plus the attention's quadratic term) is equal to
the reference's for every architecture and shape; the dry run takes the
larger of it and the count of ``torch.utils.flop_counter`` over the step.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # H100 SXM dense bf16, datasheet
HBM_BW = 3.35e12             # H100 SXM HBM3, B/s, datasheet
HBM_BYTES = 80e9             # H100 SXM device memory (80 GB)


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device FLOPs (best estimate)
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float | None     # per-device collective bytes (None: no
                                 # compiled program to parse)
    model_flops: float           # analytic MODEL_FLOPS, per device
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> None:
        return None

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs time over the dominant term."""
        t_star = max(self.t_compute, self.t_memory)
        return (self.model_flops / PEAK_FLOPS) / t_star if t_star else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "chips": self.chips, "t_compute": self.t_compute,
            "t_memory": self.t_memory, "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def active_params(cfg) -> int:
    """Parameters a token passes through: all, less the routed experts a
    token does not reach (MoE), less the embedding (a gather)."""
    from repro_torch.models.model import build
    from repro_torch.models.modules import param_count
    total = param_count(build(cfg).specs())
    if cfg.moe:
        n_moe_layers = cfg.n_layers - cfg.moe.first_dense
        per_expert = 3 * cfg.d_model * cfg.moe.expert_ff
        total -= n_moe_layers * (cfg.moe.n_experts - cfg.moe.top_k) \
            * per_expert
    return total - cfg.vocab * cfg.d_model


def model_flops_estimate(cfg, shape) -> float:
    """Analytic global FLOPs of one step: 6 N D (train) or 2 N D
    (prefill, decode), N the active parameters, D the tokens (decode: one
    a sequence), plus the attention's scores and values (train 12, prefill
    4 x L H Dh S^2 B; decode 4 x L H Dh S B against the cache).  The
    products run in the reference's order, so the floats are equal."""
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        attn = 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim \
            * shape.seq_len ** 2 * shape.global_batch if cfg.n_kv_heads else 0
        return 6.0 * n * tokens + attn
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim \
            * shape.seq_len ** 2 * shape.global_batch if cfg.n_kv_heads else 0
        return 2.0 * n * tokens + attn
    attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim \
        * shape.seq_len * shape.global_batch if cfg.n_kv_heads else 0
    return 2.0 * n * shape.global_batch + attn
