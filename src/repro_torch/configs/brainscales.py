"""The paper's own system: BrainScaleS wafer modules on an Extoll torus
(port of ``src/repro/configs/brainscales.py``).

48 FPGAs/wafer gathered at 8 concentrator torus nodes (6 FPGAs each),
8 HICANNs/FPGA, 124-event packet buckets.  Used by the SNN examples and
benchmarks; not an LM architecture."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class BrainScaleSConfig:
    n_wafers: int = 4
    fpgas_per_wafer: int = 48
    concentrators_per_wafer: int = 8
    hicanns_per_fpga: int = 8
    bucket_capacity: int = 124       # 496 B / 4 B events
    n_buckets: int = 16              # physical buckets per FPGA
    flush_margin: int = 64           # systemtime slack
    fpga_clock_mhz: float = 210.0
    microcircuit_scale: float = 1.0
    # flush-window transport (repro_torch.transport): "alltoall" ships one
    # packed exchange per window; "torus2d" / "torus3d" walk
    # dimension-ordered hops over a (torus_nx, torus_ny[, torus_nz]) torus
    # with hop-by-hop credit flow control (link_credits events per window
    # per directed egress link, spent on every hop of a row's route, 0 =
    # off).  torus3d's Z rings are the wafer-stacking axis; the paper's
    # full arrangement is (2, 4, n_wafers).
    transport: str = "alltoall"
    torus_nx: int = 0                # 0 = most-square/cubic factorization
    torus_ny: int = 0
    torus_nz: int = 0                # wafer axis (torus3d only)
    link_credits: int = 0
    notify_latency: int = 2
    # wire protocol profile (repro_torch.wire): "extoll" (64 B cells, low header
    # tax, sub-us switches) or "ethernet" (1500 B MTU, full Eth+IP+UDP
    # stack, GbE timing) — governs frame-exact bytes_on_wire and the
    # per-event latency model; step_us converts systemtime steps to wire
    # microseconds (BrainScaleS ~1000x acceleration).
    wire_format: str = "extoll"
    step_us: float = 0.1

    def transport_fields(self) -> dict:
        """The transport-selection kwargs of ``snn.simulator.SimConfig``
        (pass as ``SimConfig(..., **cfg.transport_fields())``)."""
        return dict(transport=self.transport, torus_nx=self.torus_nx,
                    torus_ny=self.torus_ny, torus_nz=self.torus_nz,
                    link_credits=self.link_credits,
                    notify_latency=self.notify_latency,
                    wire_format=self.wire_format, step_us=self.step_us)

CONFIG = BrainScaleSConfig()
