"""LM stack (port of ``src/repro/models``): every family of the
reference's model zoo."""
from repro_torch.models.model import Model, build  # noqa: F401
