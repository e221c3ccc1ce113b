"""Training configs (port of ``utils/config.py``'s ``TinySDConfig`` and
``FlowTrainConfig``).

The same fields, names and defaults as the JAX dataclasses, so the same YAML
files load. ``mesh_shape``, ``grad_accum`` and ``moe_aux_weight`` are kept
for that reason; the port's trainers run on one device and refuse values
they do not implement.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class TinySDConfig:
    """Stage-06 tiny stable diffusion training config."""

    epoch: int = 70
    epoch_awoken: Optional[int] = None
    batch_size: int = 32
    img_channel: int = 3
    img_size: int = 64
    num_class: int = 3
    T: int = 1000
    beta_1: float = 0.0015
    beta_T: float = 0.0195
    channel: int = 128
    channel_multy: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 2, 2])
    dropout: float = 0.1
    lr: float = 2.0e-6
    max_lr: float = 1.0e-4
    grad_clip: float = 1.0
    train_rand: float = 0.05
    w: float = 1.8
    nrow: int = 7
    model_dir: str = "./checkpoints/tiny_sd"
    warmup_epochs: int = 7
    dtype: str = "bf16"
    seed: int = 0
    data_dir: Optional[str] = None
    mesh_shape: Optional[dict] = None
    ema_decay: Optional[float] = None
    grad_accum: int = 1

    @classmethod
    def from_yaml(cls, path: str) -> "TinySDConfig":
        """Needs PyYAML, which the port does not otherwise use."""
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    @classmethod
    def from_dict(cls, raw: dict) -> "TinySDConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**raw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FlowTrainConfig:
    """Rectified-flow (SD3-style) MMDiT training config. ``shift`` and
    ``num_timesteps`` are the sampler's, so a trained model samples with the
    flow-Euler path of the served checkpoints."""

    epoch: int = 10
    epoch_awoken: Optional[int] = None
    batch_size: int = 8
    img_size: int = 32           # LATENT spatial size fed to the MMDiT
    context_len: int = 154       # text-context tokens (SD3: 77 + 77)
    shift: float = 3.0           # σ(t) = shift·t / (1 + (shift − 1)·t)
    num_timesteps: int = 1000
    lr: float = 1.0e-5
    max_lr: float = 1.0e-4
    warmup_epochs: int = 1
    grad_clip: float = 1.0
    train_rand: float = 0.1      # conditioning-drop probability (CFG training)
    w: float = 5.0               # CFG scale at sampling
    sample_steps: int = 50
    model_dir: str = "./checkpoints/mmdit"
    dtype: str = "bf16"
    seed: int = 0
    mesh_shape: Optional[dict] = None
    ema_decay: Optional[float] = None
    grad_accum: int = 1          # micro-batches per optimizer update
    moe_aux_weight: float = 0.01  # Switch balance-loss coefficient

    @classmethod
    def from_yaml(cls, path: str) -> "FlowTrainConfig":
        """Needs PyYAML, which the port does not otherwise use."""
        import yaml

        with open(path) as f:
            return cls(**yaml.safe_load(f))
