"""Fabric-level fault modelling (port of ``src/repro/fabric``): link and
node failure schedules that the credited torus transports consume through
``FabricState.link_down``."""
from repro_torch.fabric.faults import (  # noqa: F401
    FaultSchedule,
    cable_links,
    chaos,
    healthy,
    link_fault,
    link_flap,
    link_id,
    link_label,
    mask_at,
    n_fabric_links,
    node_fault,
    transitions,
)
