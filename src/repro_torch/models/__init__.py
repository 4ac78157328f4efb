"""LM stack (port of ``src/repro/models``): so far the Mamba-2 family and
the dense transformers."""
from repro_torch.models.model import Model, build  # noqa: F401
