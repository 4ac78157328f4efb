"""Device policy of the port (counterpart of ``src/repro/kernels/dispatch.py``).

* Entry points that create tensors take ``device``; :func:`resolve_device`
  makes ``None`` mean ``cuda`` and raises for ``cuda`` when there is no
  card, so the port never quietly runs on the CPU.
* A kernel wrapper asks :func:`on_cuda` where its tensors lie.  On CUDA it
  launches its hand-written kernel through :func:`launch`, which raises on
  any launch error; on the CPU it runs the plain PyTorch version.  There is
  no fallback from one to the other and no switch that routes the card to
  the plain version.  ``meta`` tensors (the dry run's shapes, nothing
  computed) take the plain version too: what it does to shapes is what
  the dry run counts, and nothing runs.
* :data:`LAUNCHES` counts kernel launches by kernel name, so a run can
  show that its main path went through the kernels;
  :data:`ENTRY_LAUNCHES` counts the same launches by C entry point (a
  kernel source with several, e.g. the codec's encode and decode).  A
  CUDA graph's launches count once per replay, as the eager calls it
  replays would (:func:`take_launches`, :func:`count_launches`).
* :func:`graph_launch` replays a captured CUDA graph from a thread that
  may run beside a profiler's start or stop on another thread.
"""
from __future__ import annotations

import ctypes
import functools

import torch

LAUNCHES: dict[str, int] = {}
ENTRY_LAUNCHES: dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    ENTRY_LAUNCHES.clear()


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``None`` or a CUDA device raises when CUDA is
    absent, any other device is taken as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass "
            "device='cpu' to run the plain PyTorch versions")
    return device


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU or all on ``meta``; raises on a mix or on another device
    type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def step_on_host(t) -> int:
    """A step count given as an int or as a tensor (its first element) as
    an int: for the plain versions, which run on the CPU, where reading a
    tensor costs no wait for a device."""
    return int(t.reshape(-1)[0]) if isinstance(t, torch.Tensor) else t


def launch_counts() -> tuple[dict, dict]:
    """A copy of (:data:`LAUNCHES`, :data:`ENTRY_LAUNCHES`)."""
    return dict(LAUNCHES), dict(ENTRY_LAUNCHES)


def take_launches(before: tuple[dict, dict]) -> tuple[dict, dict]:
    """Take back the launches counted since ``before`` (a
    :func:`launch_counts`) and return them.  A CUDA graph's capture counts
    nothing: each replay counts its launches (:func:`count_launches`)."""
    taken = []
    for counts, then in zip((LAUNCHES, ENTRY_LAUNCHES), before):
        taken.append({k: v - then.get(k, 0) for k, v in counts.items()
                      if v != then.get(k, 0)})
        counts.clear()
        counts.update(then)
    return tuple(taken)


def count_launches(launched: tuple[dict, dict]) -> None:
    """Count the launches of a replayed CUDA graph (:func:`take_launches`)."""
    for counts, add in zip((LAUNCHES, ENTRY_LAUNCHES), launched):
        for k, v in add.items():
            counts[k] = counts.get(k, 0) + v


def launch(kernel: str, symbol: str, *args) -> None:
    """Call C entry point ``symbol`` of the kernel library on PyTorch's
    current stream; raise if the launch reported an error; count it."""
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err}: {msg}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1
    ENTRY_LAUNCHES[symbol] = ENTRY_LAUNCHES.get(symbol, 0) + 1


@functools.lru_cache(maxsize=None)
def _cu_graph_launch():
    fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def graph_launch(graph: torch.cuda.CUDAGraph) -> None:
    """Replay ``graph`` (captured, using no RNG) on PyTorch's current
    stream through libcuda's ``cuGraphLaunch``, holding the GIL; raise
    on an error.

    ``CUDAGraph.replay`` releases the GIL around the runtime's
    ``cudaGraphLaunch``, and a profiler stopped meanwhile on another
    thread, which holds the GIL while it stops, can deadlock with that
    launch (torch 2.11, CUDA 12.8, H100: the stopping thread in the
    profiler's ``__exit__``, the launching one in ``replay``; 3 of 12
    traced serving runs, and within 30 start-stop cycles beside a serving
    engine).  Launched so, the two never overlap (60 such cycles, no
    hang)."""
    err = _cu_graph_launch()(graph.raw_cuda_graph_exec(),
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuGraphLaunch: CUresult {err}")
