"""PyTorch/CUDA port of the BrainScaleS spike-communication reproduction.

``src/repro/`` (JAX/Pallas) is the reference; this package mirrors it
module for module, so each file names its reference by path.  Ported so
far: the windowed microcircuit simulator, from the LIF steps through
aggregation, the wire codec and the exchange to delivery, on the crossbar
(``alltoall``) and on the credited Extoll torus (``torus2d`` /
``torus3d``); the one-window exchange API (``core.exchange``); fault
injection (``fabric``); the multi-tenant spike serving engine and Mamba-2
serving (``serve``); and observability (``obs``: the flight recorder,
span tracing, metrics and the run-directory report).

Conventions shared by every module:

* Event words, wire lanes and other u32 bit patterns travel as ``int32``
  tensors (torch's ``uint32`` has no shifts or comparisons on the CPU).
  Event words use 30 bits and stay non-negative; the wire ``lo`` lane uses
  bit 31, so shifts on it go through int64.
* The reference's ``shard_map`` axis is a leading tensor dimension ``S``.
* Entry points take a ``device``; it defaults to ``cuda`` and raises when
  there is none (``kernels.dispatch.resolve_device``).  On a CUDA tensor a
  kernel wrapper launches its hand-written kernel (``csrc/``); on a CPU
  tensor it runs the plain PyTorch version of the same function.

Importing the package needs neither ``nvcc`` nor a GPU: the kernel
library is built and loaded at first launch (``kernels._build``).
"""
