"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``):

    python3 chip_smoke.py

Phases, each raising on failure (exit code != 0, no result line):

1. device  -- the card's name and power limit, as nvidia-smi reports them;
2. build   -- the kernel library from ``src/repro_torch/csrc`` (sm_90a),
   and the count of tensor-core instructions (``HGMMA`` in ``cuobjdump
   -sass``) in the SSD chunk's tensor-core kernel, which must not be 0;
3. kernels -- each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' full-width shapes and on edge cases (bit
   for bit for the flush window on every ``FusedWindow`` field, the
   per-row placement (on no path since the flush window) with and without
   its wire-encode epilogue, codec, the LIF step and the LIF window, and
   bucket_scatter (the delivery kernel at the full-scale store's shapes
   in phase 5s); rtol/atol 2e-4 for the SSD chunk, whose bf16 cases take
   the tensor-core kernel and f32 cases the FMA kernel); device times per
   call (CUDA graph) of kernel and plain version; in turns: the flush
   window against the chain it replaced (route, sort, operands, per-row
   placement with its encode, residue) at the crossbar and torus shapes,
   with each chain's device functions, placement with and without the
   epilogue, one LIF window kernel against the 8-step sequence it
   replaced, and for the SSD chunk the tensor-core kernel, the FMA kernel
   on the same bf16 inputs and the plain version; bucket_scatter beside
   the parent's times; then kernel E under autograd
   (``ssd_chunk_grad``) at main path 12's shape, 8 chunks chained
   through the state: outputs and the six inputs' gradients against
   autograd of the plain loop at 2e-4 (bf16 gradients + one bf16 ulp),
   8 launches, all in the forward;
4. slice   -- a small microcircuit (scale 0.004, 4 shards, 8 windows) on
   the card against the same run of the plain versions on the CPU, with
   the same initial potentials and background drive;
5. main path 1 -- the Potjans-Diesmann microcircuit at scale 0.2 (15,431
   neurons, the largest round scale whose addresses fit the 14-bit event
   field) on 4 wafer shards, transport alltoall, wire format extoll, for
   25 windows (20 ms biological), run through the microcircuit example's
   ``main`` (``repro_torch.examples.multiwafer_microcircuit``, which
   prints the reference example's summary) after a 1-window warm-up, from
   seed-0 potentials and a drive drawn on the card; launch counts (the
   flush window and the LIF window once a window, the codec's decode once
   an exchange, the per-row placement never), deadline, overflow, residue
   and link-conservation checks, every integer ``WindowStats`` /
   ``LinkStats`` field of the first 3 windows equal to a CPU run of the
   example from the same state and drive; then a torch.profiler pass
   over 5 more windows for the device busy share and device functions
   per window; the network is kept for phase 7m;
5a. the exchange -- ``make_exchange`` at S 8, N 4096, C 256 on the tables
   of ``benchmarks/bench_transport.py`` for alltoall, torus2d 2x4 and
   torus3d 2x2x2, with link credits 512 and without, the onehot and sort
   impls, and the 6-window congestion study with the fabric state
   threaded through: every field card == CPU, the uncredited tori deliver
   what alltoall delivers, the credit identities hold, rows park and
   resume, and on every exchanged window kernel D equals
   ``aggregate(impl="sort")`` and the flush window's buckets (the
   per-row placement launched never);
5b. a small torus run (scale 0.004, torus3d 2x2x2, binding credits) on the
   card against the CPU;
5c. main path 3 -- the microcircuit at scale 0.2 over 8 wafer shards on
   torus3d 2x2x2, 25 windows: the crossbar run of the same network, the
   torus with ample credits (equal to it window for window, 0 deadline
   misses) and with credits that bind (conservation and the residue chain
   exact, deadline misses printed as the model's output); launch counts
   (the admission kernel F once per credited window), ms per window, a
   torch.profiler pass;
5d. kernel F -- the admission replay (``csrc/admission.cu``) against the
   plain replay, bit for bit on every field and its stall lane
   (``stall_lane=True``: deferred events per egress link, summing to the
   window's deferrals): on the states of 8 more windows of main path 3's
   binding run (no mask, and an all-false mask against the healthy and the
   masked replay), and on transport runs of 8 windows on torus2d 2x4 and
   torus3d 2x2x2 under the fault matrix's four schedules and chaos seeds
   0-4 (credits 24), each also card == CPU; its time without and with the
   lane, bound and the plain replay's times;
5e. a small fault run (scale 0.004, torus3d 2x2x2, chaos seed 0) on the
   card against the CPU;
5f. the fault matrix of ``benchmarks/bench_microcircuit.py`` (none, a dead
   cable, a flapping cable, a dropped node, from window 2) at main path 3's
   width and binding credits, 25 windows, one drive: window by window
   conservation, the credit identity and nothing spent or held on a dead
   link; detours where a cable dies; the drain empties the fabric; the
   healthy schedule equals the run without one; ms per window, device
   functions, rerouted / parked / deferred / deadline misses;
5n. a small recorded torus run under a dead cable and 3 segments of the
   instrumented engine, card vs CPU: every ring row (global and per
   shard) equal, traces valid;
5o. obs-sim -- main path 3's network with the flight recorder (depth 32),
   healthy and under ``link_fault(0, x+)`` from window 2, each beside the
   run without it: launches (F, A and C 25 each), every integer
   ``WindowStats`` field and ``v`` equal off vs on, the ring's counters ==
   ``LinkStats`` per window and shard, the stall table == the window's
   deferrals, device functions per credited window off and on, and a run
   directory (``build/obs/``) whose report names the congested links
   and the ``link_down`` at window 2;
5s. main path 16 -- the full-scale microcircuit (77,169 neurons, ~285 M
   synapses) built as the example builds it, 8 shards of 9,647 in the
   source address layout with a sparse store on the card; the delivery
   kernel (``csrc/synapse_deliver.cu``) against its plain version on the
   same card tensors over that store, rows of 124 and rings of 32 (the
   full-scale cell's shapes), at the cell's load and with full rows:
   rings, misses and the synapse counter bit for bit, its time (CUDA
   graph) and bound from the run's synapses and events; then 25 windows
   on the crossbar and on the cell's credited torus3d (124-event rows,
   124 credits, notify 4): launches (delivery once an exchange and
   drain), the identities, ms a window;
5t. main path 17 -- the window loop at the three microcircuit cells'
   shapes (scale 0.2 on torus3d with 124-event rows and 124 credits,
   notify 4, and on the crossbar at capacity 1,024; main path 16's
   network on the same torus): an eager loop of ``make_pipeline_fns``'
   window body against ``run_segment``'s replayed CUDA graph, 6 segments
   of 16 windows a turn from one start and the same drives, in turns
   eager, graph, graph, eager, timed with CUDA events: ms a window each
   turn, the segment counter, launches equal, and every WindowStats field
   and the end carry of the graph's turns bit for bit the eager turns';
5u. main path 18 -- NEST's HPC benchmark network at the HPC cell's scale
   (90,000 neurons in 8 shards of 11,250, in-degree 9,000 + 2,250 with
   multapses, ~1.01 B synapses, 648 M of them plastic E->E), drawn and
   partitioned on the card as ``examples/hpc_benchmark.py`` does; kernel
   C's alpha form (``lif_alpha_window``) at its 8 x 11,250 neurons: 6
   chained windows with the post-spike archive (by value and through the
   step pointer, archives past H) and 2 without, state, raster, rings and
   archive bit for bit against the plain window, its time (CUDA graph)
   and the bound of the cell's roofline count; kernel S's multapse
   instance and plastic form (``stdp_deliver``) over the scale-8 store at
   the cell's load and with full rows of 124, chained: rings, misses, the
   store's counter, plastic weights, traces, last spikes and counters bit
   for bit against the plain versions, their times and bounds from the
   window's counters; then 4 segments of 16 windows through
   ``build_sharded_segments`` with the rule on the cell's fabric
   (torus3d 2x2x2, 124-event rows, 4,096 credits, notify 4): launches of
   the replayed segments (each kernel once a window), the identities,
   plastic updates made, ``history_short`` 0, ms a window;
5g. a small serve run (the deployment of 5h for 3 segments, solo and
   contended) on the card against the same run on the CPU: every
   ``EngineReport`` integer, every per-window ``WindowServeStats`` integer
   and every latency histogram equal;
5h. main path 4 -- the multi-tenant spike serving engine at
   ``benchmarks/bench_serve.py``'s deployment behind ``BENCH_serve.json``
   (8 shards on torus3d 2x2x2, capacity 32, link credits 64, tenants
   quiet (reserve 32, 40 events a window) and hot (reserve 8, 600 events
   a window, bursts), 24 segments of 8 windows), solo, contended and
   contended under ``link_fault(0, x+)`` from window 2, each after
   ``warmup()``: per-tenant conservation, the quiet tenant's p99 factor
   (at most 4.0), per-tenant counts and latency beside the file's, the
   launches per served window (the tenant form of kernel F, B's encode
   and B's decode once each), events/s and ms per window, peak device
   memory, and a torch.profiler pass over one served segment; then the
   program's clock beside the profiler's: the deployment, contended and
   solo, served by the engine's own threads with a tracer under
   torch.profiler for 0.5 s, the spans put on the profiler's clock by
   ``obs.spans.on_profiler_clock`` (the two anchors, no fitted offset):
   at least 99% of the device thread's ``cudaLaunchKernel`` and
   ``cudaMemcpyAsync`` events lie inside a span that thread wrote, and as
   many have their kernel or copy in the profiler's trace; the device's
   idle gaps named by the innermost such span; 2 s more of serving without
   the profiler, read by stage (ms per window, time off the CPU, the
   stats wait); the summary in ``build/serve_clock.json``;
5p. obs-serve -- 5h's contended run with the flight recorder (depth 256)
   and a tracer, beside a plain contended run in the same call:
   ``BENCH_serve.json``'s model outputs and QoS factor, launches per
   window, ring delivered totals == the ledger, a valid trace with spans on
   ``spike-ingest`` and ``spike-device``, window instants on ``device``
   and every one among the ring's windows, a run directory with parsable
   metrics and both tenants; ms per served window, events/s and device
   functions per served window, instrumented and not;
5i. kernel F's tenant form against the plain replay, bit for bit on
   every field and the stall lane, on the states of every 6th window of
   each of 5h's runs (without a mask also under an all-false mask against
   the healthy and the masked replay); its time (CUDA graph) without and
   with the lane against its chain bound, and the replay's times;
5q. kernel G (``csrc/cycle_models.cu``) on small traces that reach the
   bucket model's corners (the clipped append, invalid words and negative
   destinations, the 15-bit wrap, a queue of 1, 32 arrivals a cycle, 40
   buckets, capacity 1, 2^14 destinations) and 8 small ring runs, card
   against CPU bit for bit;
5r. main path 5 -- the cycle-level models at the benchmark scripts' sizes:
   ``bench_renaming.py``'s 8 + 4 traces (T 1200), ``bench_aggregation.py
   :model_throughput``'s two (T 2000), ``tests/test_core.py``'s two
   paper-claim traces and one long trace (T 100,000, 4 arrivals a cycle, 16
   buckets, 1,024 destinations) through ``bucket.run_trace``, and
   ``bench_ringbuffer.py``'s 18 + 3 runs (2,000 steps) through
   ``flow_control.run``: one launch of G each, every output and state
   field bit for bit against the plain versions on the CPU; the model
   outputs (events per cycle, mean packet, misses, stall fraction, ring
   throughput beside ``min(1, size / (lat + 1))``) and the paper's two
   §3.1 claims; G's times (CUDA graph) on the long trace and a
   bench_renaming trace beside its chain bound and the plain versions';
6. Mamba-2 slice -- the reduced mamba2 (2 layers; its blocks compute in
   bf16, so the SSD chunk takes the tensor-core kernel) on the card
   against the CPU: hidden states, caches and decode at the model
   tolerance 5e-2, and greedy serving with the same tokens where the
   CPU's margin exceeds it; then the f32 route: the chunked SSD scan on
   f32 inputs at the serving widths (2 chunks, 2 launches of the FMA
   kernel), card against CPU at 2e-4;
7. main path 2 -- mamba2-2.7b at its published width (64 layers, d_model
   2560, 80 heads x 64, d_state 128, chunk 256, vocab 50,280), random bf16
   weights from seed 0, serving 8 requests of 300-600 prompt tokens
   through 4 slots, 16 new tokens each: prefill ms per wave, decode ms per
   step, peak memory, the SSD-chunk launch counts (the tensor-core kernel
   64 x the chunks of every wave's prefill, the FMA kernel never, none in
   decode) and finite outputs; prefill + decode
   against the full forward at 2 and 64 layers, with three cache faults
   planted to show that the check sees them; the same requests served
   with a tracer (``serve/prefill`` and ``serve/decode`` spans, a valid
   trace, the same tokens); then torch.profiler passes over one prefill
   wave and 8 decode steps;
7a. the dense transformers (qwen3-32b, qwen1.5-4b, gemma2-9b, minicpm-2b)
   reduced, card against CPU: hidden, prefill and decode at 5e-2;
7b. main path 6 -- gemma2-9b at its published widths (42 layers, d_model
   3584, 16 / 8 heads of 256, d_ff 14336, vocab 256,000; 9.24 B parameters,
   random bf16 from seed 0): 8 requests of 300-600 tokens through 4 slots,
   then 2 requests of 4,400 tokens at max_len 4,480 (the local layers'
   window of 4,096 binds), 16 new tokens each: prefill ms and prompt
   tokens/s per wave, decode ms per step, peak memory; prefill + decode
   against the full forward (no argmax flip above a 0.25 margin, the
   difference in units of the row RMS); a value planted in layer 0's K and
   V more than a window behind the decoded token leaves the logits bit for
   bit, at layer 0's newest position and at layer 1's (global) position 0
   it moves them past their limit; torch.profiler over one prefill wave
   and 8 decode steps;
   then main path 13 -- the same model and parameters decoding split-KV
   (``Engine(rt=Runtime(mesh 1x8, split_kv_axis="model"))``, the mesh
   virtual: the cache's shard axis a leading tensor dimension): 2
   requests of 4,400 tokens into caches of 16,384 slots (8 shards of
   2,048; shards 3-7 hold no valid slot, the local window binds), 16 new
   tokens; 8 teacher-forced steps split vs unsplit from the same prefill
   caches (the flip rule, max |dlogit| in row-RMS units), one local and
   one global layer's attention split vs unsplit in f32 at 2e-4, ms a
   step both ways, peak memory, a torch.profiler pass over one step each
   way, 0 launches;
   and main path 15 -- its forward on the context-parallel runtime
   (``Runtime(mesh 1x8, seq_axis="model")``: the group-GQA route, G = 2)
   on 2 x 4,096 tokens without a gradient against the expand route
   (within ``TOL_SHARDED`` of the RMS), ms and peak memory both ways, 0
   launches;
7c. the rest of the model zoo reduced (deepseek-moe-16b, arctic-480b,
   qwen2-vl-7b with vision embeddings and positions3, recurrentgemma-9b
   on rings of 16, whisper-large-v3), card against CPU: hidden, prefill
   (every cache field) and one decode step (the LM head's input, caches)
   at 5e-2; no kernel launched.  Then one full-width model at a time,
   random bf16 weights from seed 0, each with its prefill ms and tokens/s,
   decode ms per step, peak memory, 0 kernel launches, prefill + decode
   against the full forward with main path 6's flip rule (no flip among
   at least 5 rows whose top-2 margin exceeds 0.25 row RMS), and
   torch.profiler over one prefill and 8 decode steps:
7d. main path 7 -- deepseek-moe-16b (28 layers, the first dense; 64
   experts top-6 + 2 shared; 16.38 B parameters): main path 2's 8
   requests through 4 slots at the published capacity factor 1.25, each
   prefill wave's dropped fraction; the check at a factor of E / k where
   nothing drops (asserted); ``moe_layer_bucket`` with EP 8 as a leading
   dimension against ``moe_layer_local`` on layer 0's weights in f32 and
   the prefill wave's hidden states at 2e-4; then main path 14 -- its
   prefill through the sharded bucket dispatch (``Runtime(mesh 1x8,
   moe_impl="bucket", seq_axis="model")``, the reference's prefill-cell
   runtime) on 4 x 560 tokens: each route's dropped fraction at 1.25;
   at E / k the hidden states at every position against the local
   dispatch's (within ``TOL_SHARDED`` of the RMS), the last 8 positions'
   logits (flip rule), 0 dropped, the pmean'd and local stats side by side, 0
   launches; then one arctic-480b layer
   (n_layers 1 of 35: 128 experts top-2, the parallel dense MLP; 14.07 B
   parameters) on 4 x 556 tokens;
7e. main path 8 -- qwen2-vl-7b (7.62 B parameters): 4 requests served at
   1 slot with their own vision embeddings (1, 256, 3584) and grid
   positions3; a 4 x 556-token prefill with them; the check at positions3
   = the broadcast arange, where M-RoPE is RoPE;
7f. main path 9 -- recurrentgemma-9b (9.40 B parameters) on ring KV
   caches of 2,048: 2 requests of 2,040 tokens, 16 new tokens (the ring
   wraps at step 9), the 16 steps checked; a value at the slot the next
   step overwrites leaves the logits bit for bit, at the newest slot it
   moves them past ``TOL_RING_FAULT``;
7g. main path 10 -- whisper-large-v3 (1.54 B parameters) on 1,500
   frames: 2 x 440 tokens through encode, ``fill_cross_cache``, prefill
   and 8 decode steps, checked; 4 requests served at 1 slot, each with
   its own frames (the only width at which the reference's engine serves
   its launcher's requests);
7h. train-small -- one train step of each of the ten reduced
   architectures, card against CPU on the same f32 parameters and
   ``synthetic_batch`` (2 x 32 tokens): loss, nll, z, aux and grad_norm
   at 1e-2 relative, each gradient leaf's RMS difference within 5e-2 of
   its RMS (MoE experts allowing one routing flip), the reduced Mamba-2's
   gradients reaching in_proj, conv and A_log through kernel E (8
   launches: 2 layers x 2 chunks, forward and recompute); the optimizer
   on the CPU's gradients card vs CPU at 1e-6 (arctic: Adafactor with a
   bf16 momentum, within one ulp); reduced minicpm-2b with per-layer
   remat on against off; the reference's trainer test on the card (20
   steps, the loss falls, checkpoints every 10 under
   ``build/train_ckpt``, the step-20 checkpoint == the state bit for bit,
   a crash injected at 25, the restart resumes at 20 and ends at 40);
7i. main path 11 -- minicpm-2b trained at full width (40 layers,
   d_model 2304, vocab 122,753; 2.725 B f32 parameters, AdamW, the WSD
   schedule at lr 1e-3 with warmup 1), built as ``launch/train.py``
   builds it: ``synthetic_batch`` through the prefetcher, 2 x 4,096
   tokens a step (MiniCPM's context), 4 steps, no checkpoint: every
   step's loss and grad_norm finite, the last loss below the first, lr
   == the schedule's formula at 1e-6, 0 launches; ms a step (median of
   steps 3-4, synchronised), tokens/s, peak memory and a torch.profiler
   pass over one more step;
7j. main path 12 -- mamba2-2.7b trained at full width the same way, 2 x
   2,048 tokens a step (Mamba-2's pretraining context), 4 steps: kernel
   E's tensor-core route launched 64 layers x 8 chunks x 2 (the forward
   and the per-layer recompute) a step, the FMA route never;
7k. distributed -- ``compressed_psum`` over 4 replicated parties on a
   minicpm-2b gradient tree at full width (2 x 4,096 tokens), every leaf
   within the reference test's bounds, the int8 payload and scales of 3
   leaves == the CPU's bit for bit, ms a tree; ``pipelined_all_to_all``
   in 4 chunks on the exchange's (src, dst, capacity) payload == one
   transpose; ``launch/train.py``'s trainer, reduced: deepseek-moe-16b
   with ``--mesh 1x4 --moe-impl bucket`` (the sharded dispatch under
   autograd) against the mesh-free run, 4 losses within ``TOL_MESH_LOSS``
   relative (the first within ``TOL_MESH_FIRST``), and qwen3-32b with
   ``--mesh 2x4``, which reads no mesh axis, == the mesh-free run's;
7l. dry run -- ``launch.dryrun.run_cell`` on ``meta`` for qwen3-32b x
   train_4k and gemma2-9b x decode_32k with split-KV on the 16x16 mesh:
   per-device GiB against 80 GB, counted against analytic FLOPs, the
   bottleneck (analytic: datasheet rates, nothing timed);
7m. the user entry points (``repro_torch.examples``, ``repro_torch.tools``)
   called as a user calls them: the microcircuit example at scale 0.2 on
   ``torus3d ethernet`` (a 1x2x2 torus of the 4 shards; main path 1's
   network, main path 1 being its ``alltoall extoll`` run), 25 windows
   after a 1-window warm-up from seed-0 potentials and a drive drawn on
   the card, with 0 deadline misses and overflows, launches flush_window
   25, lif_step 25, wire_codec 26, ms a window, and every integer
   ``WindowStats`` / ``LinkStats`` field of the first 3 windows equal to
   a CPU run of the entry point from the same state and drive; the
   quickstart (kernel A
   once, G once; its buckets, bucket state and cycle outputs == the
   CPU's); ``serve_lm`` (reduced gemma2, 10 requests, tokens/s);
   ``train_100m`` at its defaults (200 steps of 8 x 256 tokens, checkpoints
   under ``build/``; the loss falls; tokens/s, ms a step, peak memory);
   the trace smoke into ``build/trace_smoke`` (exit 0; a tenant-form F,
   an encode and a decode a served window; the engine it served, 4
   shards on 2x2x1, held to the same engine on the CPU on every report
   integer, every ``WindowServeStats`` integer and the global and
   per-shard recorder rows);
8. the ``kernels`` lines (a summary, then one JSON object; each kernel's
   launches come from the path of this slice that runs it, its counts set
   to 0 just before that path: A-C and F from main path 3, F and B also
   from main path 4's three runs, A-C and F from obs-sim's recorded runs
   and F and B from obs-serve's instrumented run, A-C from main path 1
   and the entry points' torus run, A-C, F, H's rotation and delivery
   from main path 16's two runs, A, B, C's alpha form, F, H's rotation,
   delivery and the plastic delivery from main path 18's replayed
   segments, A and G from the quickstart and F and B
   from the trace smoke (the per-row placement 0: it is on no path), D
   from the exchange,
   E's tensor-core kernel from main paths 2 and 12, E's FMA kernel from
   the f32 scan of phase 6, G's two forms from main path 5) and, last,
   the device JSON line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
FP32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12           # H100 SXM dense bf16 on the tensor cores

SCALE = 0.2
N_SHARDS = 4
N_WINDOWS = 25
FULL_SCALE = 1.0               # the whole microcircuit: 77,169 neurons
FULL_SHARDS = 8
FULL_PER = 9647                # its neurons a shard over 8 shards
FULL_E_MAX = 16384             # the example's and the benchmark's e_max
FULL_CELL_C = 124              # the full-scale benchmark cell's rows


T_START = time.perf_counter()


def banner(title: str) -> None:
    """A phase's title, with the seconds since the script started (so a
    later slice can see which phase to cut to stay in half the limit)."""
    print(f"\n== {title} (at {time.perf_counter() - T_START:.0f} s)",
          flush=True)


def time_ms(fn, calls: int = 10, reps: int = 20) -> tuple[float, float]:
    """(device ms, eager ms) per call of ``fn``, medians over ``reps``.

    Device time: ``calls`` calls captured in one CUDA graph and replayed,
    CUDA events around each replay, so the host's launch overhead is not
    in it.  Eager time: events around ``calls`` back-to-back calls from
    Python, which for a microsecond kernel measures the host.
    """
    def per_call(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    def eager():
        for _ in range(calls):
            fn()

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    eager_ms = statistics.median(per_call(eager) for _ in range(reps))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = statistics.median(per_call(graph.replay)
                                  for _ in range(reps))
    return device_ms, eager_ms


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a.dtype == torch.bool:
            a, b = a.to(torch.int32), b.to(torch.int32)
        d = (a.to(torch.float64) - b.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def require_equal(what: str, pairs) -> None:
    for i, (a, b) in enumerate(pairs):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version (shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}, max abs err "
                                 f"{max_abs_err([(a, b)])})")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _words(gen, shape, n_addr=1 << 14, p_valid=0.9):
    from repro_torch.core import events as ev
    dev = gen.device
    addr = torch.randint(0, n_addr, shape, generator=gen, device=dev)
    ts = torch.randint(0, 1 << 15, shape, generator=gen, device=dev)
    valid = torch.rand(shape, generator=gen, device=dev) < p_valid
    return ev.pack(addr, ts, valid=valid)


def check_placement(gen, cfg, n_lut):
    """Kernel A's per-row placement, which the flush window replaced on
    every path (kept with its checks: the sort-based chain that
    ``check_flush_window`` times runs it), at the main path's shapes (S
    windows of residue + e_max * max_fan events, D = S destinations, C =
    capacity), then ragged edge cases; both variants, each without and
    with the encode epilogue in three word formats (the payload also
    against ``encode_plain`` of the rows the kernel placed); plus the
    whole fused window on the card against the CPU.  Times placement with and without the epilogue in
    turns: the difference is what the fused encode costs."""
    from repro_torch.kernels import fused_route_bucket as frb
    from repro_torch.wire import codec
    dev = gen.device

    def operands(b, n, d, c, routed, biased):
        words = _words(gen, (b, n))
        if biased:      # most traffic to destination 0: its row overflows
            probs = torch.tensor([0.05, 0.45, 0.25, 0.15, 0.05, 0.05][:d + 2],
                                 device=dev)
            dest = torch.multinomial(probs.expand(b, -1).contiguous(), n,
                                     True, generator=gen) - 1
        else:
            dest = torch.randint(-1, d + 1, (b, n), generator=gen, device=dev)
        dest = dest.to(torch.int32)          # -1 and d are out of range
        if routed:
            lut = torch.randint(-5, 1 << 20, (b, n_lut if biased else 96),
                                generator=gen, device=dev,
                                dtype=torch.int32)
            skey, swords = frb.sort_by_destination(words, dest, d)
            return frb.placement_operands(skey, swords, lut, d, c,
                                          routed=True)
        meta = torch.randint(-2**31, 2**31 - 1, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)
        skey, swords, smeta = frb.sort_by_destination(words, dest, d, meta)
        return frb.placement_operands(skey, swords, smeta, d, c,
                                      routed=False)

    S, C = cfg.n_shards, cfg.capacity
    n_main = cfg.residue + cfg.e_max * cfg.max_fan
    err = 0.0
    cases = [(S, n_main, S, C, True), (3, 1000, 7, 33, False),
             (2, 63, 7, 1, False), (1, 257, 13, 19, False),
             (5, 300, 4, 16, False)]
    fmts = (None, codec.DEFAULT_WORD, codec.WireWordFormat(16, 14, 20),
            codec.WireWordFormat(15, 14, 0))
    for routed in (False, True):
        for b, n, d, c, biased in cases:
            ops = operands(b, n, d, c, routed, biased)
            for fmt in fmts:
                what = f"placement routed={routed} {(b, n, d, c)} {fmt}"
                got = frb.placement(*ops, c, routed=routed, wire_fmt=fmt)
                want = frb.placement_plain(*ops, c, routed=routed,
                                           wire_fmt=fmt)
                require_equal(what, list(zip(got, want)))
                err = max(err, max_abs_err(zip(got, want)))
                if fmt is not None:
                    require_equal(f"{what}: payload vs encode_plain", [(
                        got[2], torch.cat(codec.encode_plain(
                            got[0], got[1], fmt), dim=-1))])
            if biased and int(ops[1].max()) <= c:
                raise AssertionError("placement: no overflowing row tested")
    # the whole fused window (sort + kernel) on the card vs the CPU
    words = _words(gen, (S, n_main))
    probs = torch.tensor([1, 8, 2, 1, 1, 1.0], device=dev)
    dest = (torch.multinomial(probs.expand(S, -1).contiguous(), n_main, True,
                              generator=gen) - 1).to(torch.int32)
    meta = torch.randint(-2**31, 2**31 - 1, (S, n_main), generator=gen,
                         device=dev, dtype=torch.int32)
    fw_gpu = frb.fused_aggregate(words, dest, meta, S, C,
                                 residue_len=cfg.residue,
                                 with_residue_meta=True,
                                 wire_fmt=codec.DEFAULT_WORD)
    fw_cpu = frb.fused_aggregate(words.cpu(), dest.cpu(), meta.cpu(), S, C,
                                 residue_len=cfg.residue,
                                 with_residue_meta=True,
                                 wire_fmt=codec.DEFAULT_WORD)
    require_equal("fused_aggregate card vs CPU", [
        (a.cpu(), b) for a, b in zip(
            list(fw_gpu.buckets) + list(fw_gpu[1:]),
            list(fw_cpu.buckets) + list(fw_cpu[1:]))
        if a is not None or b is not None])

    ops = operands(S, n_main, S, C, False, True)
    first, counts, swords_pad, aux = ops
    fmt = codec.DEFAULT_WORD
    fns = {"encode": lambda: frb.placement(*ops, C, routed=False,
                                           wire_fmt=fmt),
           "bare": lambda: frb.placement(*ops, C, routed=False)}
    times = {k: [] for k in fns}
    for order in (("bare", "encode"), ("encode", "bare")):
        for k in order:
            times[k].append(time_ms(fns[k]))
    (ms, eager_ms), (bare_ms, _) = (
        tuple(statistics.mean(v) for v in zip(*times[k])) for k in fns)
    plain_ms, plain_eager_ms = time_ms(
        lambda: frb.placement_plain(*ops, C, routed=False, wire_fmt=fmt))
    live = int(torch.clamp(counts, max=C).sum())
    # indices, live words and metas read; rows of words, metas and
    # payload lanes written
    n_bytes = first.numel() * 8 + live * 8 + first.numel() * C * 16
    bms, by = bound_ms(n_bytes, first.numel() * C * 24)
    print(f"placement at the path's shape: with the encode epilogue "
          f"{ms:.4f} ms, without {bare_ms:.4f} ms: the fused encode costs "
          f"{ms - bare_ms:.4f} ms")
    return dict(name="placement", route="cuda",
                source="src/repro_torch/csrc/placement.cu",
                replaces="src/repro/kernels/fused_route_bucket.py:122",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms, bare_ms=bare_ms,
                parity="on no path since the flush window; bit-exact "
                       "(both variants, 5 shapes, without and with the "
                       "encode epilogue in 3 word formats); timed with the "
                       "epilogue")


FLUSH_MODES = (("dest", "meta"), ("dest_lut", "meta"),
               ("dest_lut", "guid_lut"), ("dest", "guid_lut"))
FLUSH_FMTS = (None, (15, 14, 32), (16, 14, 20), (15, 14, 0))  # 2nd: default


def _flush_inputs(gen, b, n, d, mode, how, n_lut=200, n_guid=70):
    """Operands of ``flush_window``: (b, n) words (10% with the valid bit
    clear, addresses up to n_lut + 19, so tables clamp), destinations -1 ..
    d per event or per address (``how``: "uniform"; "biased", most to 0
    and 1, so both overflow; "one", all to d // 2), meta per event or a
    GUID table."""
    dev = gen.device

    def dests(shape):
        if how == "one":
            return torch.full(shape, d // 2, dtype=torch.int32, device=dev)
        probs = torch.ones(d + 2, device=dev)
        if how == "biased":
            probs[1:3] += 4 * d
        k = shape[0] * shape[1]
        flat = torch.multinomial(probs, max(k, 1), True, generator=gen)[:k]
        return (flat.reshape(shape) - 1).to(torch.int32)

    words = _words(gen, (b, n), n_addr=n_lut + 20)
    kw = {"dest": dests((b, n))} if mode[0] == "dest" else \
        {"dest_lut": dests((b, n_lut))}
    if mode[1] == "meta":
        kw["meta"] = torch.randint(-2**31, 2**31 - 1, (b, n), generator=gen,
                                   device=dev, dtype=torch.int32)
    else:
        kw["guid_lut"] = torch.randint(-5, 1 << 20, (b, n_guid),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
    return words, kw


def _window_fields(fw):
    return [("buckets." + k, v) for k, v in fw.buckets._asdict().items()] + \
        [(k, v) for k, v in fw._asdict().items() if k != "buckets"]


def _route_chain(words, dest_lut, meta, d, c, r, fmt):
    """The sequence the flush-window kernel replaced on the simulator's
    path: the route (address, clamp, table lookup), then the sort-based
    chain (``fused_aggregate``: stable sort and gathers, run edges, pads,
    the per-row placement kernel with its encode, the residue's second
    sort and gathers, reductions)."""
    from repro_torch.core import events as ev
    from repro_torch.core.routing import lookup
    from repro_torch.kernels import fused_route_bucket as frb
    addr = torch.clamp(ev.address(words), max=dest_lut.shape[-1] - 1)
    return frb.fused_aggregate(words, lookup(dest_lut, addr), meta, d, c,
                               residue_len=r, with_residue_meta=True,
                               wire_fmt=fmt)


def check_flush_window(gen, cfg, n_lut):
    """Kernel A's flush window against its plain version, bit for bit on
    every ``FusedWindow`` field: the crossbar path's shape (S windows of
    residue + e_max * max_fan events, the destination table and meta per
    event), the credited torus's with its held rows (8 windows of 8 x C +
    residue + e_max x 8 events), the exchange's routed shape (8 x 4096, D 8,
    C 256, both tables), the full-scale source layout's (8 windows of 8 x
    124 held rows + residue + 16,384 x 8 events, a destination and meta
    per event), then ragged cases (n 0 and 1, C 1, D 13, no
    residue, a residue longer than n or shorter than the overflow, two
    overflowing destinations, every event to one destination, a window
    split over a cluster of 8 blocks) in all four operand combinations;
    each in three word formats and none; wherever the destinations are per
    event, with the residue's destinations (``with_residue_dest``, the
    source layout's lane).  Then, in turns at the crossbar
    and torus shapes, the kernel against the chain it replaced (the route
    and ``fused_aggregate``), each chain's device functions counted."""
    from repro_torch.core import events as ev
    from repro_torch.kernels import fused_route_bucket as frb
    from repro_torch.wire import codec
    S, C, R = cfg.n_shards, cfg.capacity, cfg.residue
    n_main = R + cfg.e_max * cfg.max_fan
    n_torus = 8 * C + R + cfg.e_max * 8
    shapes = [  # label, (b, n, d, c, r), modes, how, n_lut, n_guid
        ("crossbar", (S, n_main, S, C, R), FLUSH_MODES[1:2], "biased",
         n_lut, 70),
        ("torus with held rows", (8, n_torus, 8, C, R), FLUSH_MODES[1:2],
         "biased", n_lut, 70),
        ("exchange", (8, 4096, 8, 256, 0), FLUSH_MODES[2:3], "uniform",
         1024, 64),
        ("full-scale source layout", (8, 8 * FULL_CELL_C + R
                                      + FULL_E_MAX * 8, 8, FULL_CELL_C, R),
         FLUSH_MODES[0:1], "biased", FULL_PER, 70)]
    shapes += [(f"ragged {case}", case, FLUSH_MODES, how, 200, 70)
               for case, how in (((2, 0, 4, 8, 5), "uniform"),
                                 ((2, 1, 4, 8, 5), "uniform"),
                                 ((2, 63, 7, 1, 16), "biased"),
                                 ((1, 257, 13, 19, 300), "biased"),
                                 ((5, 300, 4, 16, 0), "biased"),
                                 ((3, 600, 3, 8, 20), "biased"),
                                 ((3, 1000, 7, 33, 128), "uniform"),
                                 ((2, 9000, 5, 100, 50), "one"))]
    err, n_cases, two_overflow, clipped = 0.0, 0, False, False
    for label, (b, n, d, c, r), modes, how, lut_n, guid_n in shapes:
        for mode in modes:
            words, kw = _flush_inputs(gen, b, n, d, mode, how, lut_n, guid_n)
            kw.update(residue_len=r, with_residue_meta=mode[1] == "meta",
                      with_residue_dest=mode[0] == "dest")
            for f in FLUSH_FMTS:
                fmt = None if f is None else codec.WireWordFormat(*f)
                got = frb.flush_window(words, d, c, wire_fmt=fmt, **kw)
                want = frb.flush_window_plain(words, d, c, wire_fmt=fmt, **kw)
                what = f"flush_window {label} {mode} fmt {f}"
                for (name, a), (_, e) in zip(_window_fields(got),
                                             _window_fields(want)):
                    if (a is None) != (e is None):
                        raise AssertionError(f"{what}: {name} present in one")
                    if a is not None:
                        require_equal(f"{what}: {name}", [(a, e)])
                        err = max(err, max_abs_err([(a, e)]))
                n_cases += 1
            ovf = (want.buckets.counts == c).sum(-1)
            two_overflow |= bool(((ovf >= 2) & (want.buckets.overflow > 0)
                                  ).any())
            clipped |= bool((want.dropped > 0).any())
    if not (two_overflow and clipped):
        raise AssertionError("flush_window: no window with two overflowing "
                             "destinations or a clipped residue tested")

    fmt = codec.DEFAULT_WORD
    timed = {}
    for label, b, n, d in (("crossbar", S, n_main, S),
                           ("torus", 8, n_torus, 8)):
        words = _words(gen, (b, n), n_addr=n_lut)
        lut = torch.randint(0, d, (b, n_lut), generator=gen, device=gen.device,
                            dtype=torch.int32)
        meta = torch.randint(0, 1 << 20, (b, n), generator=gen,
                             device=gen.device, dtype=torch.int32)
        fns = {"kernel": lambda: frb.flush_window(
                   words, d, C, dest_lut=lut, meta=meta, residue_len=R,
                   with_residue_meta=True, wire_fmt=fmt),
               "chain": lambda: _route_chain(words, lut, meta, d, C, R, fmt)}
        for (name, a), (_, e) in zip(_window_fields(fns["kernel"]()),
                                     _window_fields(fns["chain"]())):
            if (a is None) != (e is None):
                raise AssertionError(f"flush_window vs the chain at {label}:"
                                     f" {name} present in one")
            if a is not None:
                require_equal(f"flush_window vs the chain at {label}: "
                              f"{name}", [(a, e)])
        times = {k: [] for k in fns}
        for order in (("kernel", "chain"), ("chain", "kernel")):
            for k in order:
                times[k].append(time_ms(fns[k]))
        timed[label] = {k: tuple(statistics.mean(v) for v in zip(*times[k]))
                        for k in fns}
        timed[label]["functions"] = {
            k: profile_device(fns[k], f"one call of the {k} at the {label} "
                              f"shape", 1, "call", top=0) for k in fns}
        if label == "crossbar":
            plain = time_ms(lambda: frb.flush_window_plain(
                words, d, C, dest_lut=lut, meta=meta, residue_len=R,
                with_residue_meta=True, wire_fmt=fmt))
            # each input read once: words, meta and the table entries the
            # valid words address; each output written once: rows, metas,
            # payload lanes, counts, residue and its meta, 4 scalars
            valid = ev.is_valid(words)
            addr = torch.clamp(ev.address(words), max=n_lut - 1)
            entries = sum(int(torch.unique(addr[i][valid[i]]).numel())
                          for i in range(b))
            n_bytes = (8 * b * n + 4 * entries + 16 * b * d * C + 4 * b * d
                       + 8 * b * R + 16 * b)
            bms, by = bound_ms(n_bytes, 30 * b * n)
    for label, t in timed.items():
        f = t["functions"]
        print(f"flush_window at the {label} shape: kernel {t['kernel'][0]:.4f}"
              f" ms ({f['kernel']} device functions), the chain it replaced "
              f"(route + sort + operands + per-row placement with its encode "
              f"+ residue) {t['chain'][0]:.4f} ms ({f['chain']} device "
              f"functions), in turns")
    (ms, eager_ms), (chain_ms, _) = (timed["crossbar"]["kernel"],
                                     timed["crossbar"]["chain"])
    return dict(name="flush_window", route="cuda",
                source="src/repro_torch/csrc/flush_window.cu",
                replaces="src/repro/kernels/fused_route_bucket.py:122",
                max_abs_err=err, ms=ms, plain_ms=plain[0], bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain[1], chain_ms=chain_ms,
                torus_ms=timed["torus"]["kernel"][0],
                torus_chain_ms=timed["torus"]["chain"][0],
                parity=f"bit-exact on every FusedWindow field ({n_cases} "
                       f"cases: 4 path shapes, the full-scale source "
                       f"layout's among them, 8 ragged in 4 operand "
                       f"combinations, 3 word formats and none; the "
                       f"residue's destinations wherever destinations are "
                       f"per event); timed at the crossbar shape")


def check_codec(gen, cfg):
    """Kernel B on one exchange's (S, S, C) words: encode, then decode of
    the payload columns of the packed (S, S, 2C + 1) buffer, in three word
    formats.  On the simulator and fused exchange paths the encode runs
    inside placement (``check_placement``), so B's launches there are
    decodes: its time is the decode's, with the standalone encode +
    decode beside it."""
    from repro_torch.core import events as ev
    from repro_torch.transport import base as tb
    from repro_torch.wire import codec
    dev = gen.device
    S, C = cfg.n_shards, cfg.capacity
    shape = (S, S, C)
    words = _words(gen, shape)
    meta = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                         dtype=torch.int32)
    flat_w, flat_m = words.view(-1), meta.view(-1)
    flat_m[:4] = torch.tensor([-1, 2**31 - 1, -2**31, 0], device=dev)
    flat_w[:4] = ev.pack(torch.full((4,), ev.ADDR_MASK, device=dev),
                         torch.full((4,), ev.TS_MASK, device=dev))
    flat_w[4] = 0                                        # INVALID word
    err = 0.0
    for fmt in (codec.DEFAULT_WORD, codec.WireWordFormat(16, 14, 20),
                codec.WireWordFormat(15, 14, 0)):
        buf = codec.encode_planar(words, meta, fmt)
        want = torch.cat(codec.encode_plain(words, meta, fmt), dim=-1)
        require_equal(f"wire encode {tuple(fmt)}", [(buf, want)])
        counts = torch.randint(0, C, (S, S), generator=gen, device=dev,
                               dtype=torch.int32)
        rows, _ = tb.unpack_payload(tb.pack_payload(buf, counts))
        got = codec.decode_planar(rows, fmt)
        want = codec.decode_plain(rows[..., :C], rows[..., C:], fmt)
        require_equal(f"wire decode {tuple(fmt)}", list(zip(got, want)))
        err = max(err, max_abs_err(zip(got, want)))
        if fmt == codec.DEFAULT_WORD:
            require_equal("wire round trip", [(got[0], words),
                                              (got[1], meta)])
    counts = torch.full((S, S), C, dtype=torch.int32, device=dev)
    rows, _ = tb.unpack_payload(tb.pack_payload(
        codec.encode_planar(words, meta), counts))
    ms, eager_ms = time_ms(lambda: codec.decode_planar(rows))
    plain_ms, plain_eager_ms = time_ms(
        lambda: codec.decode_plain(rows[..., :C], rows[..., C:]))
    both_ms, _ = time_ms(lambda: codec.decode_planar(
        codec.encode_planar(words, meta)))
    n = words.numel()
    bms, by = bound_ms(n * 16, n * 10)
    print(f"wire_codec at one exchange's {n} words: decode {ms:.4f} ms "
          f"(bound {bms:.6f} ms), standalone encode + decode "
          f"{both_ms:.4f} ms")
    return dict(name="wire_codec", route="cuda",
                source="src/repro_torch/csrc/wire_codec.cu",
                replaces="src/repro/wire/codec.py:172",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms, both_ms=both_ms,
                parity="bit-exact (encode+decode, 3 formats); timed: the "
                       "decode of the packed rows")


def check_lif(gen, cfg):
    """Kernel C on the (S, per) neurons of the main path: ``lif_step``
    over 20 chained steps, then ``lif_window`` over 6 chained windows of
    the path's 8 steps off a 32-slot ring (t0 from 20, so windows wrap),
    and on edge cases (slots kept, a ragged size, 20 steps, a slot met
    twice); refractory neurons and neurons at and near threshold; state,
    spikes and rings bit for bit.  Then, in turns, one window through the
    kernel against the sequence it replaces: 8 x (ring + drive, a
    single-step launch, 2 slot clears) and the stack of the raster."""
    from repro_torch.kernels import lif_step as ls
    from repro_torch.snn import lif
    dev = gen.device
    p = cfg.params
    shape = (cfg.n_shards, cfg.per_shard)
    W, L = cfg.window, cfg.ring_len
    u = lambda *s: torch.rand(s or shape, generator=gen, device=dev)

    def fresh(shape):
        st = lif.LIFState(
            v=p.e_l + (p.v_th - p.e_l + 2.0) * u(*shape),
            i_exc=u(*shape) * 500.0, i_inh=-u(*shape) * 200.0,
            refrac=torch.randint(-1, 25, shape, generator=gen, device=dev,
                                 dtype=torch.int32))
        st.v.view(-1)[:64] = p.v_th             # exactly at threshold
        return st

    state = fresh(shape)
    err, spikes = 0.0, 0
    for step in range(20):
        exc, inh = u() * 2000.0, -u() * 300.0
        got_st, got_spk = ls.lif_step(state, p, exc, inh)
        want_st, want_spk = ls.lif_step_plain(state, p, exc, inh)
        pairs = list(zip(got_st, want_st)) + [(got_spk, want_spk)]
        require_equal(f"lif step {step}", pairs)
        err = max(err, max_abs_err(pairs))
        spikes += int(got_spk.sum())
        state = got_st
    if spikes == 0 or int((state.refrac > 0).sum()) == 0:
        raise AssertionError("lif: threshold or refractory path unexercised")

    def window_case(what, st, ring_len, t0, n_steps, clear):
        nonlocal err
        shp = tuple(st.v.shape)
        re = u(ring_len, *shp) * 2000.0
        ri = -u(ring_len, *shp) * 300.0
        drive = torch.poisson(u(n_steps, *shp) * 1.3, generator=gen) * 87.8
        rings = (re.clone(), ri.clone())
        got_st, got_spk = ls.lif_window(st, p, *rings, t0, drive, clear)
        want_st, want_spk = ls.lif_window_plain(st, p, re, ri, t0, drive,
                                                clear)
        pairs = (list(zip(got_st, want_st)) + [(got_spk, want_spk)]
                 + list(zip(rings, (re, ri))))
        require_equal(f"lif window {what}", pairs)
        err = max(err, max_abs_err(pairs))
        return got_st, int(got_spk.sum())

    state, w_spikes = fresh(shape), 0
    for k in range(6):
        state, n = window_case(f"{k} (t0 {20 + k * W})", state, L,
                               (20 + k * W) % L, W, True)
        w_spikes += n
    for what, shp, ring_len, t0, n_steps, clear in (
            ("slots kept", shape, L, 28, W, False),
            ("ragged", (3, 1001), 16, 13, 5, True),
            ("20 steps", shape, 24, 10, 20, True),
            ("a slot met twice", (2, 500), 6, 3, 8, True)):
        window_case(what, fresh(shp), ring_len, t0, n_steps, clear)
    if w_spikes == 0 or int((state.refrac > 0).sum()) == 0:
        raise AssertionError("lif window: threshold or refractory path "
                             "unexercised")

    re, ri = u(L, *shape) * 2000.0, -u(L, *shape) * 300.0
    drive = torch.poisson(u(W, *shape) * 1.3, generator=gen) * 87.8

    def old_sequence():
        st, spk = state, []
        for k in range(W):
            slot = (20 + k) % L
            st, s_k = ls.lif_step(st, p, re[slot] + drive[k], ri[slot])
            re[slot].zero_()
            ri[slot].zero_()
            spk.append(s_k)
        return st, torch.stack(spk)

    fns = {"window": lambda: ls.lif_window(state, p, re, ri, 20, drive),
           "steps": old_sequence,
           "plain": lambda: ls.lif_window_plain(state, p, re, ri, 20, drive)}
    times = {k: [] for k in fns}
    for order in (("window", "steps", "plain"), ("plain", "steps", "window")):
        for k in order:
            times[k].append(time_ms(fns[k]))
    (ms, eager_ms), (steps_ms, steps_eager_ms), (plain_ms, plain_eager_ms) = (
        tuple(statistics.mean(v) for v in zip(*times[k])) for k in fns)
    exc, inh = u(), u()
    step_ms, _ = time_ms(lambda: ls.lif_step(state, p, exc, inh))
    n = state.v.numel()
    # per window: the state read once and written once, per step two ring
    # slots and the drive read, two zeros and a spike written
    n_bytes = n * (16 + 16 + W * (12 + 8 + 1))
    bms, by = bound_ms(n_bytes, n * 15 * W)
    print(f"lif_step: one {W}-step window of {n} neurons: window kernel "
          f"{ms:.4f} ms, the sequence it replaces (8 x (add, single-step "
          f"launch, 2 zero_) + stack) {steps_ms:.4f} ms, plain window "
          f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}, {n_bytes} B); "
          f"eager: {eager_ms:.4f} / {steps_eager_ms:.4f} / "
          f"{plain_eager_ms:.4f} ms; one single step {step_ms:.4f} ms")
    return dict(name="lif_step", route="cuda",
                source="src/repro_torch/csrc/lif_step.cu",
                replaces="src/repro/kernels/lif_step.py:78",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms, steps_ms=steps_ms,
                step_ms=step_ms,
                parity=f"bit-exact (20 steps, {spikes} spikes; 6 chained "
                       f"{W}-step windows with wrap, {w_spikes} spikes; 4 "
                       f"edge windows); timed per window")


def _ssd_inputs(gen, bh, c, P, N, dtype, bg=None):
    """One SSD chunk's operands: x, B, C in ``dtype`` (as the conv gives
    them), dt, A, s_prev in f32; B and C per group when ``bg`` < ``bh``."""
    dev = gen.device
    bg = bh if bg is None else bg
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return (r(bh, c, P).to(dtype),
            torch.nn.functional.softplus(r(bh, c)),
            -torch.exp(r(bh) * 0.3),
            (r(bg, c, N) * 0.3).to(dtype), (r(bg, c, N) * 0.3).to(dtype),
            r(bh, P, N) * 0.1)


def count_hgmma(lib_path, kernel: str) -> int:
    """HGMMA (Hopper tensor-core) instructions in the functions of the built
    library whose name holds ``kernel``, as ``cuobjdump -sass`` lists
    them."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "HGMMA" in line:
            count += 1
    return count


def check_ssd_chunk(gen, bh, chunk, head_dim, d_state, bg, hgmma):
    """Kernel E at the serving path's shape (BH = slots x heads pairs,
    c = chunk, P = head_dim, N = d_state, bf16 x / B / C as the conv gives
    them, B and C per group: ``bg`` = slots x groups rows) and on edge
    cases: B and C per pair, f32 inputs, short and long chunks (the long
    one takes more than 48 KB of shared memory), ragged tiles, one pair.
    The bf16 cases take the tensor-core kernel, the f32 cases the FMA
    kernel (``ssd_chunk.route``; the launch counts show which ran).  Both
    outputs at rtol/atol 2e-4 (f32 sums in another order; the tensor-core
    kernel's split f32 operands keep ~16 bits).  Returns the rows of the
    two kernels."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ssd_chunk as ssd
    bf16, f32 = torch.bfloat16, torch.float32
    main = (bh, chunk, head_dim, d_state, bf16, bg)
    cases = [main, (bh, chunk, head_dim, d_state, bf16, None),
             (bh, chunk, head_dim, d_state, f32, bg),
             (1, 16, 8, 16, f32, None), (6, 100, 80, 72, bf16, 2),
             (3, 1, 4, 4, f32, None), (2, 2048, 16, 24, bf16, 1),
             (5, 257, 64, 128, f32, None),
             # the tensor-core tiling: ragged row, P and N tiles; one pair
             (4, 320, 48, 40, bf16, 2), (1, 64, head_dim, d_state, bf16,
                                         None)]
    err = {"ssd_chunk_tc": 0.0, "ssd_chunk_f32": 0.0}
    n_cases = dict.fromkeys(err, 0)
    for case in cases:
        ins = _ssd_inputs(gen, *case)
        kernel = ssd.route(ins[0].dtype, ins[3].dtype, ins[4].dtype)
        dispatch.reset_launches()
        got = ssd.ssd_chunk(*ins)
        if dispatch.LAUNCHES != {ssd.KERNELS[kernel][0]: 1}:
            raise AssertionError(f"ssd_chunk {case}: launches "
                                 f"{dispatch.LAUNCHES}, want one {kernel}")
        want = ssd.ssd_chunk_plain(*ins)
        for name, a, b in zip(("y", "s_new"), got, want):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4,
                                       msg=lambda m: f"{kernel} {case} "
                                       f"{name}: {m}")
        err[kernel] = max(err[kernel], max_abs_err(zip(got, want)))
        n_cases[kernel] += 1
    # the three versions on the path's inputs, in turns, one call
    ins = _ssd_inputs(gen, *main)
    fns = {"tc": ssd.ssd_chunk_tc, "fma": ssd.ssd_chunk_fma,
           "plain": ssd.ssd_chunk_plain}
    times = {k: [] for k in fns}
    for order in (("tc", "fma", "plain"), ("plain", "fma", "tc")):
        for k in order:
            times[k].append(time_ms(lambda f=fns[k]: f(*ins)))
    (ms, eager_ms), (fma_ms, fma_eager_ms), (plain_ms, plain_eager_ms) = (
        tuple(statistics.mean(v) for v in zip(*times[k])) for k in fns)
    x, dt, A, B, C, s_prev = ins
    n_bytes = sum(t.numel() * t.element_size() for t in ins) + \
        4 * (x.numel() + s_prev.numel())               # y and s_new, f32
    # the causal lower triangle (j <= i) of the two intra-chunk products,
    # the carried-state product and the state update
    flops = bh * (chunk * (chunk + 1) * (d_state + head_dim)
                  + 4 * chunk * head_dim * d_state)
    common = dict(route="cuda", replaces="src/repro/kernels/ssd_chunk.py:80",
                  plain_ms=plain_ms, library_ms=None,
                  plain_eager_ms=plain_eager_ms)
    bms, by = bound_ms(n_bytes, flops, BF16_OPS_PER_S)
    tc = dict(common, name="ssd_chunk",
              source="src/repro_torch/csrc/ssd_chunk_tc.cu",
              max_abs_err=err["ssd_chunk_tc"], ms=ms, bound_ms=bms,
              bound_by=by, eager_ms=eager_ms, hgmma=hgmma,
              parity=f"rtol/atol 2e-4 ({n_cases['ssd_chunk_tc']} bf16 "
                     f"shapes, B/C per group and per pair); {hgmma} HGMMA "
                     f"in its SASS; FMA kernel on the same inputs "
                     f"{fma_ms:.4f} ms")
    bms, by = bound_ms(n_bytes, flops, FP32_OPS_PER_S)
    fma = dict(common, name="ssd_chunk_f32",
               source="src/repro_torch/csrc/ssd_chunk.cu",
               max_abs_err=err["ssd_chunk_f32"], ms=fma_ms, bound_ms=bms,
               bound_by=by, eager_ms=fma_eager_ms,
               parity=f"rtol/atol 2e-4 ({n_cases['ssd_chunk_f32']} f32 "
                      f"shapes); timed on the path's bf16 inputs")
    return [tc, fma]


def _scatter_bytes(batch, n, d, c):
    """Kernel D's input read once and output written once."""
    return batch * (12 * n + 8 * d * c + 4 * d)


def check_bucket_scatter(gen):
    """Kernel D at the exchange path's shape (8 shard windows of N 4096,
    D 8 destinations, C 256, one launch), at (N 4096, D 64, C 128) alone
    and with a shard axis of 8, on ragged shapes and on windows that span
    every block of a cluster, bit for bit against its plain version;
    destinations -1 .. D (out of range matches no row)."""
    from repro_torch.kernels import bucket_scatter as bs
    dev = gen.device
    path = ((8,), 4096, 8, 256)
    wide = ((), 4096, 64, 128)
    # the last two span every block of a cluster of 8
    cases = [path, wide, ((8,), 4096, 64, 128), ((), 100, 13, 7),
             ((8,), 128, 3, 124), ((8,), 1024, 64, 16), ((3,), 1000, 7, 33),
             ((2,), 1, 5, 0), ((2,), 0, 4, 8), ((4,), 20000, 8, 256),
             ((2,), 9000, 3, 5000)]

    def inputs(batch, n, d, c):
        words = _words(gen, batch + (n,))
        dests = torch.randint(-1, d + 1, batch + (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        guids = torch.randint(-2**31, 2**31 - 1, batch + (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        return words, dests, guids, d, c

    err, overflowed = 0.0, 0
    for case in cases:
        ins = inputs(*case)
        got = bs.bucket_scatter(*ins)
        want = bs.bucket_scatter_plain(*ins)
        require_equal(f"bucket_scatter {case}", list(zip(got, want)))
        err = max(err, max_abs_err(zip(got, want)))
        overflowed += int((want[2] > case[3]).sum())
    if overflowed == 0:
        raise AssertionError("bucket_scatter: no row over capacity tested")
    times = {}
    for case in (path, wide):
        ins = inputs(*case)
        times[case] = (time_ms(lambda: bs.bucket_scatter(*ins)),
                       time_ms(lambda: bs.bucket_scatter_plain(*ins)))
    (ms, eager_ms), (plain_ms, plain_eager_ms) = times[path]
    batch, n, d, c = path
    b = batch[0]
    bms, by = bound_ms(_scatter_bytes(b, n, d, c), b * n * d)
    (w_ms, _), (w_plain, _) = times[wide]
    w_bound, _ = bound_ms(_scatter_bytes(1, *wide[1:]), 4096 * 64)
    print(f"bucket_scatter at (N 4096, D 64, C 128): kernel {w_ms:.4f} ms, "
          f"plain {w_plain:.4f} ms, bound {w_bound:.6f} ms (bytes, "
          f"{_scatter_bytes(1, *wide[1:])} B)")
    print(f"bucket_scatter, one cluster per window: {ms:.4f} ms at (8, 4096, "
          f"8, 256), {w_ms:.4f} ms at (4096, 64, 128); the previous design, "
          f"one block per row, as PERF.md records it: 0.008958 and 0.0097 "
          f"ms")
    return dict(name="bucket_scatter", route="cuda",
                source="src/repro_torch/csrc/bucket_scatter.cu",
                replaces="src/repro/kernels/bucket_scatter.py:79",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms,
                parity=f"bit-exact ({len(cases)} shapes, shard axis 8)")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the whole slice.
# ---------------------------------------------------------------------------

def sim_config(part, **kw):
    """The simulator's configuration for ``part``; ``kw`` sets the sizes
    and overrides the transport fields of ``configs.brainscales``."""
    from repro_torch.configs import brainscales
    from repro_torch.snn import simulator as sim
    return sim.SimConfig(n_shards=part.n_shards, per_shard=part.per_shard,
                         max_fan=part.fanout.shape[1], window=8, ring_len=32,
                         **{**brainscales.CONFIG.transport_fields(), **kw})


def check_slice_small():
    """Card vs CPU for the whole window loop at a small size, with the same
    initial potentials and drive: integer stats exact, floats within the
    LIF tolerances (sums over events run in another order)."""
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    spec = mc.MicrocircuitSpec(scale=0.004)
    part = network.build_partition(*spec.weight_matrix(), n_shards=N_SHARDS)
    cfg = sim_config(part, e_max=256, capacity=4, residue=64)
    n_win = 8
    rng = np.random.default_rng(0)
    drive = torch.from_numpy(rng.poisson(
        1.3, (n_win, cfg.window, N_SHARDS, cfg.per_shard)).astype(
            np.float32) * np.float32(87.8))
    out = {}
    for device in ("cpu", "cuda"):
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          device=device)
        st = init(0)
        if device == "cpu":
            v0 = st.neuron.v
        st = st._replace(neuron=st.neuron._replace(v=v0.to(device)),
                         generator=None)
        out[device] = run(st, n_win, drive=drive)
    from repro_torch.convert import flatten
    s_cpu, s_gpu = flatten(out["cpu"][1]), flatten(out["cuda"][1])
    for key, a in s_cpu.items():
        b = s_gpu[key]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        elif not (a == b).all():
            raise AssertionError(f"slice card vs CPU: {key} differs")
    st_cpu, st_gpu = out["cpu"][0], out["cuda"][0]
    np.testing.assert_allclose(st_gpu.neuron.v.cpu(), st_cpu.neuron.v,
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(st_gpu.ring_exc.cpu(), st_cpu.ring_exc,
                               rtol=1e-5, atol=1e-3)
    if not torch.equal(st_gpu.neuron.refrac.cpu(), st_cpu.neuron.refrac):
        raise AssertionError("slice card vs CPU: refrac differs")
    spikes = int(s_cpu["spikes"].sum())
    deferred = int(s_cpu["deferred"].sum())
    if spikes == 0 or deferred == 0:
        raise AssertionError("slice check: no spikes or no residue traffic")
    print(f"slice check (scale 0.004, {n_win} windows): card == CPU on every "
          f"integer stat; {spikes} spikes, {deferred} deferred events")


def quiet(fn):
    """``fn()`` with its standard output dropped (warm-ups, CPU twins)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def entry_inputs(net, cfg):
    """Seed-0 potentials and the background drive of ``N_WINDOWS`` windows
    for the microcircuit example's ``net``, drawn on the card (the state
    keeps the generator for runs without a drive), and their copies on the
    CPU: (state, drive, cpu_state, cpu_drive)."""
    from repro_torch.snn import lif
    from repro_torch.snn import simulator as sim
    part = net.part
    S, per = part.n_shards, part.per_shard
    rates = net.spec.bg_rates()
    bg = torch.from_numpy(np.pad(rates, (0, part.n_neurons - len(rates)))
                          .reshape(S, per).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ring = torch.zeros((cfg.ring_len, S, per), dtype=torch.float32,
                       device="cuda")
    state = sim.ShardState(
        lif.init_state((S, per), cfg.params, generator=gen, device="cuda"),
        ring, ring.clone(), torch.zeros((S,), dtype=torch.int32,
                                        device="cuda"), gen)
    drive = lif.poisson_input(bg.expand((N_WINDOWS, cfg.window, S, per)),
                              87.8, cfg.params.dt, generator=gen)
    cpu_state = sim.ShardState(*(tree_to(x, "cpu") for x in state[:4]))
    return state, drive, cpu_state, drive.cpu()


ENTRY_CHECK_WINDOWS = 3           # windows of each card run held to the CPU


def check_entry_windows(card, net, transport, fmt, cpu_state,
                        cpu_drive) -> tuple[int, int]:
    """Every integer ``WindowStats`` / ``LinkStats`` field of the card
    run's first ``ENTRY_CHECK_WINDOWS`` windows equal to a CPU run of the
    microcircuit example from the same state and drive (floats at rtol
    1e-6) -> (integer fields held, spikes in those windows)."""
    from repro_torch.convert import flatten
    from repro_torch.examples import multiwafer_microcircuit as ex
    cpu = quiet(lambda: ex.main(
        transport, fmt, net=net, state=cpu_state,
        drive=cpu_drive[:ENTRY_CHECK_WINDOWS],
        n_windows=ENTRY_CHECK_WINDOWS, device="cpu"))
    got, ref = flatten(card.stats), flatten(cpu.stats)
    n_int = 0
    for key, a in ref.items():
        b = got[key][:, :ENTRY_CHECK_WINDOWS]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        elif b.shape != a.shape or not (a == b).all():
            raise AssertionError(f"{transport} {fmt}: {key} card != CPU in "
                                 f"the first {ENTRY_CHECK_WINDOWS} windows")
        else:
            n_int += 1
    return n_int, int(ref["spikes"].sum())


def run_main_path(smi: str):
    """Main path 1: the microcircuit example at scale 0.2 on ``alltoall
    extoll``, called as a user calls it (``examples.multiwafer_microcircuit
    .main``) after a 1-window warm-up, from seed-0 potentials and a drive
    drawn on the card; its launches, checks, the first windows card ==
    CPU and a profile.  Returns (launches, the network) so that the
    entry-point phase reuses the network."""
    from repro_torch.core import events as ev
    from repro_torch.examples import multiwafer_microcircuit as ex
    from repro_torch.kernels import dispatch
    from repro_torch.snn import simulator as sim

    t0 = time.perf_counter()
    net = ex.build_network(SCALE)
    part = net.part
    if part.per_shard * part.fanout.shape[1] > ev.ADDR_MASK + 1:
        raise AssertionError("event addresses exceed the 14-bit field")
    cfg = ex.sim_config(net)
    state, drive, cpu_state, cpu_drive = entry_inputs(net, cfg)
    quiet(lambda: ex.main(net=net, state=state, drive=drive[:1],
                          n_windows=1, device="cuda"))     # warm-up
    torch.cuda.synchronize()
    print(f"set-up (network on the host, upload, warm-up): "
          f"{time.perf_counter() - t0:.1f} s")

    print(f"\n$ python -m repro_torch.examples.multiwafer_microcircuit "
          f"alltoall extoll --scale {SCALE}  [{smi}; seed-0 state and a "
          f"drive drawn on the card]")
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    torch.cuda.synchronize()
    res = ex.main(net=net, state=state, drive=drive, device="cuda")
    launches = dict(dispatch.LAUNCHES)
    stats = res.stats

    s = {k: v.cpu().numpy() for k, v in (
        ("spikes", stats.spikes), ("sent", stats.events_sent),
        ("miss", stats.deadline_miss), ("ovf", stats.overflow),
        ("off", stats.offered), ("defr", stats.deferred))}
    link = {k: getattr(stats.link, k).cpu().numpy() for k in (
        "offered_events", "sent_events", "delivered_events")}
    ms_window = res.wall_s * 1e3 / N_WINDOWS
    print(f"{N_WINDOWS} windows in {res.wall_s * 1e3:.1f} ms: "
          f"{ms_window:.3f} ms per window, "
          f"{ms_window / (cfg.window * cfg.params.dt):.2f}x slower than "
          f"biological time; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- checks ---------------------------------------------------------
    if int(s["spikes"].sum()) <= 0:
        raise AssertionError("network is silent")
    if int(s["miss"].sum()) != 0 or int(s["ovf"].sum()) != 0:
        raise AssertionError("deadline misses or bucket overflows on the "
                             "main path")
    if not np.isfinite(res.state.neuron.v.cpu().numpy()).all():
        raise AssertionError("non-finite membrane potentials")
    off, snt, defr, drop = s["off"], s["sent"], s["defr"], s["ovf"]
    if not (off == snt + defr + drop).all():
        raise AssertionError("residue identity: offered != sent + deferred "
                             "+ dropped")
    new = off - np.concatenate([np.zeros((N_SHARDS, 1), off.dtype),
                                defr[:, :-1]], axis=1)
    if not ((new >= 0).all() and (new.sum(1) == snt.sum(1) + drop.sum(1)
                                  + defr[:, -1]).all()):
        raise AssertionError("residue identity across windows broken")
    if not (link["offered_events"] == link["sent_events"]).all():
        raise AssertionError("link conservation: offered != sent")
    if not (link["sent_events"].sum(0) == link["delivered_events"].sum(0)
            ).all():
        raise AssertionError("link conservation: sum(sent) != sum(delivered)")
    # one LIF window launch and one flush window per window; the encode
    # runs inside the flush window, so the codec decodes each exchange
    # (+1: the drain's); the per-row placement runs no more
    want = {"flush_window": N_WINDOWS, "wire_codec": N_WINDOWS + 1,
            "lif_step": N_WINDOWS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    print(f"launches on the main path: {launches}")
    n_int, spikes = check_entry_windows(res, net, "alltoall", "extoll",
                                        cpu_state, cpu_drive)
    print(f"{n_int} integer WindowStats / LinkStats fields of the first "
          f"{ENTRY_CHECK_WINDOWS} windows card == CPU ({spikes} spikes in "
          f"them)")
    _, run = sim.build_sharded_sim(cfg, part, net.spec.bg_rates(),
                                   device="cuda")
    window_functions(run, res.state, 5)
    return launches, net


def window_functions(run, state, n_windows: int,
                     reps: int = 3) -> float | None:
    """Profiles of ``n_windows`` windows + drain and of 1 window + drain;
    their difference over ``n_windows - 1`` is the device functions of one
    window with the drain taken out (the first profile's count per
    "window" divides by ``n_windows + 1``, the drain counted as one).
    Each profile is taken ``reps`` times and the largest count kept: the
    profiler at times drops a launch (one run saw 2 of a 3-window run's 3
    admission launches), it never invents one."""
    counts = []
    for n, what, top in ((n_windows, f"{n_windows} windows + drain", 12),
                         (1, "1 window + drain", 0)):
        seen = [profile_device(lambda: run(state, n), what, n + 1,
                               "window", top=top if r == 0 else 0)
                for r in range(reps)]
        if any(c is None for c in seen):
            return None
        counts.append(max(seen))
    many, one = counts
    if many is None or one is None:
        return None
    per = (many - one) / (n_windows - 1)
    print(f"device functions per window, the drain taken out: {per:.1f}")
    return per


def profile_device(fn, what: str, n_units: int, unit: str,
                   top: int = 12) -> int | None:
    """Device busy share and the ``top`` costliest device functions over
    one call of ``fn`` (torch.profiler) -> the count of device functions;
    prints "not measured" and returns None when the profiler sees no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():   # device-side rows only: kernels, copies
        if e.device_type == DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("profile: device time not measured (no device activity seen)")
        return None
    launches = sum(r[1] for r in rows)
    print(f"profile of {what}: wall {wall_us:.0f} us, device busy "
          f"{busy:.0f} us ({100 * busy / wall_us:.1f}%), {launches} device "
          f"functions ({launches / n_units:.0f} per {unit})")
    for dev, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {dev:9.1f} us {count:5d}x  {key[:90]}")
    return launches


def profile_decode(model, params, batch: dict, max_len: int, what: str):
    """torch.profiler over one prefill of ``batch`` and over 8 greedy
    decode steps after it: device functions and busy share."""
    state = {}

    def run_prefill():
        caches = model.init_caches(len(batch["tokens"]), max_len,
                                   device="cuda")
        h, state["caches"] = model.prefill(params, batch, caches)
        state["tok"] = model.logits(params, h[:, -1:, :]).argmax(-1)

    def run_decode():
        for _ in range(8):
            logits, state["caches"] = model.decode(params, state["caches"],
                                                   state["tok"])
            state["tok"] = logits.argmax(-1)

    B, S = batch["tokens"].shape
    profile_device(run_prefill, f"one {what} prefill wave ({B} x {S} "
                   f"tokens)", model.cfg.n_layers, "layer")
    profile_device(run_decode, f"8 {what} decode steps ({B} slots)", 8,
                   "step")


# ---------------------------------------------------------------------------
# The exchange and the credited torus.
# ---------------------------------------------------------------------------

X_SHARDS, X_EVENTS, X_CAPACITY, X_CREDITS, X_ADDR = 8, 4096, 256, 512, 1024
X_STUDY_WINDOWS = 6
X_CASES = (("alltoall", "alltoall", None),
           ("torus2d 2x4", "torus2d", {"nx": 2, "ny": 4}),
           ("torus2d 2x4 credits", "torus2d",
            {"nx": 2, "ny": 4, "link_credits": X_CREDITS}),
           ("torus3d 2x2x2", "torus3d", {"nx": 2, "ny": 2, "nz": 2}),
           ("torus3d 2x2x2 credits", "torus3d",
            {"nx": 2, "ny": 2, "nz": 2, "link_credits": X_CREDITS}))


def exchange_inputs(device):
    """The routing tables of benchmarks/bench_transport.py (8 shards, 1,024
    addresses each, address a -> shard (7a + s) % 8, one local link) and a
    window of 4,096 events per shard from a numpy seed."""
    from repro_torch.core import events as ev, routing as rt
    from repro_torch.snn.simulator import stack_tables
    tabs = [rt.build_tables(X_ADDR, [
        rt.Projection(a, a + 1, dest_node=(a * 7 + s) % X_SHARDS,
                      dest_links=[a % 3]) for a in range(X_ADDR)],
        n_guid=64, device="cpu") for s in range(X_SHARDS)]
    rng = np.random.default_rng(0)
    words = ev.pack(torch.from_numpy(rng.integers(0, X_ADDR,
                                                  (X_SHARDS, X_EVENTS))),
                    torch.from_numpy(rng.integers(0, 1000,
                                                  (X_SHARDS, X_EVENTS))))
    return words.to(device), stack_tables(tabs, device=device)


def require_same_outputs(what, got, want, rtol=1e-6):
    """Integer fields of two flattened trees equal, float fields within
    ``rtol`` (the same f32 arithmetic, sums maybe in another order)."""
    from repro_torch.convert import flatten
    a, b = flatten(got), flatten(want)
    if set(a) != set(b):
        raise AssertionError(f"{what}: fields differ: {set(a) ^ set(b)}")
    for key, x in a.items():
        y = b[key]
        if x.shape != y.shape:
            raise AssertionError(f"{what}: {key} shape {x.shape} vs {y.shape}")
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-6,
                                       err_msg=f"{what}: {key}")
        elif not (x == y).all():
            raise AssertionError(f"{what}: {key} differs")


def check_window_buckets(words, tables):
    """Kernel D (``ops.bucket_scatter``) on the routed words of one
    exchanged window against ``aggregate(impl="sort")`` and the flush
    window's buckets (kernel A)."""
    from repro_torch.core import aggregator
    from repro_torch.kernels import fused_route_bucket as frb, ops
    dest, guid, routed = tables.route(words)
    masked = torch.where(routed, words, 0)
    by_d = ops.bucket_scatter(masked, dest, guid, X_SHARDS, X_CAPACITY)
    by_sort = aggregator.aggregate(masked, dest, guid, X_SHARDS, X_CAPACITY,
                                   impl="sort")
    fused = frb.flush_window(words, X_SHARDS, X_CAPACITY,
                             dest_lut=tables.dest_of_addr,
                             guid_lut=tables.guid_of_addr).buckets
    require_equal("bucket_scatter vs aggregate(sort)",
                  list(zip(by_d, by_sort)))
    require_equal("bucket_scatter vs fused buckets", list(zip(by_d, fused)))
    return by_d


def check_credit_identities(what, link, state, limit):
    if not (link.offered_events == link.sent_events + link.deferred_events
            + link.parked_events).all():
        raise AssertionError(f"{what}: offered != sent + deferred + parked")
    if not (link.stalled_by_hop.sum(-1) == link.deferred_events).all():
        raise AssertionError(f"{what}: deferred != stalled_by_hop sum")
    held = state.bank.credits + state.bank.pending.sum(-1) \
        + state.parked_by_link
    if not (held == limit).all():
        raise AssertionError(f"{what}: credits + pending + held != limit")


def _study(words, tables, n_windows):
    """The congestion study of benchmarks/_fabric_study.py: the same
    offered window every window, the fabric state threaded through."""
    from repro_torch import transport as tp
    from repro_torch.core.exchange import exchange_window
    tb = tp.create("torus3d", n_shards=X_SHARDS, max_row_events=X_CAPACITY,
                   **X_CASES[-1][2])
    state = tb.init_state(2 * X_CAPACITY, device=words.device)
    outs = []
    for _ in range(n_windows):
        out = exchange_window(words, tables, n_shards=X_SHARDS,
                              capacity=X_CAPACITY, transport=tb,
                              link_state=state)
        state = out.link_state
        outs.append(out)
    return outs


def run_exchange_path():
    """``make_exchange`` at S 8, N 4096, C 256 on the card for the
    crossbar and both tori, with and without credits, the staged impls on
    the credited torus3d, and the 6-window congestion study; kernel D on
    every exchanged window.  Then each against the same run on the CPU."""
    from repro_torch.core.exchange import make_exchange
    from repro_torch.kernels import dispatch
    words, tables = exchange_inputs("cuda")
    runs = {label: make_exchange(n_shards=X_SHARDS, capacity=X_CAPACITY,
                                 n_addr_per_shard=X_ADDR, transport=backend,
                                 transport_opts=opts)
            for label, backend, opts in X_CASES}
    impls = {impl: make_exchange(n_shards=X_SHARDS, capacity=X_CAPACITY,
                                 n_addr_per_shard=X_ADDR, impl=impl,
                                 transport="torus3d",
                                 transport_opts=X_CASES[-1][2])
             for impl in ("onehot", "sort")}
    dispatch.reset_launches()
    torch.cuda.synchronize()
    outs, windows = {}, 0
    for label, run in runs.items():
        outs[label] = run(words, tables)
        check_window_buckets(words, tables)
        windows += 1
    for impl, run in impls.items():
        outs[impl] = run(words, tables)
        check_window_buckets(words, tables)
        windows += 1
    study = _study(words, tables, X_STUDY_WINDOWS)
    for _ in study:
        check_window_buckets(words, tables)
        windows += 1
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    credited = (sum("link_credits" in (o or {}) for _, _, o in X_CASES)
                + len(impls) + X_STUDY_WINDOWS)
    if launches.get("bucket_scatter") != windows or "placement" in \
            launches or launches.get("admission") != credited or \
            not all(launches.get(k, 0) > 0
                    for k in ("flush_window", "wire_codec")):
        raise AssertionError(f"exchange path launches {launches}: want "
                             f"bucket_scatter {windows}, admission "
                             f"{credited}, flush_window and wire_codec > 0, "
                             f"placement 0")

    words_c, tables_c = exchange_inputs("cpu")
    for label, run in runs.items():
        require_same_outputs(f"exchange {label} card vs CPU", outs[label],
                             run(words_c, tables_c))
    for impl in impls:
        require_same_outputs(f"exchange impl={impl} vs fused", outs[impl],
                             outs[X_CASES[-1][0]], rtol=0)
    ref = outs["alltoall"]
    for label, _, opts in X_CASES[1:]:
        out = outs[label]
        if "link_credits" in opts:
            check_credit_identities(label, out.link, out.link_state,
                                    X_CREDITS)
            if int(out.link.credit_stalls.sum()) == 0:
                raise AssertionError(f"{label}: credits never bound")
            continue
        for field in ("recv_events", "recv_guids", "recv_counts",
                      "link_events"):
            if not torch.equal(getattr(out, field), getattr(ref, field)):
                raise AssertionError(f"{label}: {field} differs from "
                                     f"alltoall")
    study_cpu = _study(words_c, tables_c, X_STUDY_WINDOWS)
    for k, (g, c) in enumerate(zip(study, study_cpu)):
        require_same_outputs(f"study window {k} card vs CPU", g, c)
        check_credit_identities(f"study window {k}", g.link, g.link_state,
                                X_CREDITS)
    total = lambda f: sum(int(getattr(o.link, f).sum()) for o in study)
    if total("parked_events") == 0 or total("unparked_events") == 0:
        raise AssertionError("study: no row parked and resumed mid-route")
    for label, run in runs.items():
        o = outs[label]
        t0 = time.perf_counter()
        for _ in range(5):
            run(words, tables)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"exchange {label}: {ms:.2f} ms per window (host clock); "
              f"delivered {int(o.link.delivered_events.sum())}, stalls "
              f"{int(o.link.credit_stalls.sum())}, parked "
              f"{int(o.link.parked_events.sum())}, hops "
              f"{int(o.link.hops[0])}, forwarded bytes "
              f"{int(o.link.forwarded_bytes.sum())}, bytes on wire "
              f"{int(o.link.bytes_on_wire.sum())}")
    p99 = max(float(o.latency.p99_us.max()) for o in study)
    print(f"congestion study (torus3d 2x2x2, credits {X_CREDITS}, "
          f"{X_STUDY_WINDOWS} windows): stalls {total('credit_stalls')}, "
          f"parked {total('parked_events')}, unparked "
          f"{total('unparked_events')}, hop-0 deferrals "
          f"{total('deferred_events')}, forwarded bytes "
          f"{total('forwarded_bytes')}, dwell "
          f"{sum(float(o.link.queue_dwell_us.sum()) for o in study):.3f} us,"
          f" p99 {p99:.3f} us; card == CPU in every window")
    print(f"kernel D on {windows} exchanged windows == aggregate(sort) == "
          f"fused buckets; launches on the exchange path: {launches}")
    return launches


TORUS_SHARDS = 8
TORUS_RUNS = {
    "alltoall": dict(transport="alltoall"),
    "torus3d, ample credits": dict(transport="torus3d", torus_nx=2,
                                   torus_ny=2, torus_nz=2,
                                   link_credits=1 << 20),
    # the paper's 124-event buckets, each link's credits one bucket,
    # returned 4 windows after they are spent
    "torus3d, binding credits": dict(transport="torus3d", torus_nx=2,
                                     torus_ny=2, torus_nz=2, capacity=124,
                                     link_credits=124, notify_latency=4),
}
# WindowStats fields that do not depend on the fabric's shape
SAME_ON_EVERY_FABRIC = ("spikes", "events_sent", "overflow", "wire_bytes",
                        "deadline_miss", "offered", "deferred",
                        "link.offered_events", "link.sent_events",
                        "link.deferred_events", "link.delivered_events",
                        "link.credit_stalls", "link.parked_events",
                        "link.unparked_events", "link.in_fabric_events")


def check_backpressure_chain(what, stats, n_shards):
    """The identities of tests/test_transport.py's congested run, on
    numpy-flattened WindowStats (S, n_windows)."""
    g = lambda k: stats["link." + k]
    checks = {
        "offered == sent + deferred + parked": (
            g("offered_events") == g("sent_events") + g("deferred_events")
            + g("parked_events")).all(),
        "sum(sent) + sum(unparked) == sum(delivered)": (
            (g("sent_events") + g("unparked_events")).sum(0)
            == g("delivered_events").sum(0)).all(),
        "deferred == stalled_by_hop sum": (
            g("stalled_by_hop").sum(-1) == g("deferred_events")).all(),
        "in-fabric balance": (g("in_fabric_events") == np.concatenate(
            [np.zeros((n_shards, 1), np.int64),
             g("in_fabric_events")[:, :-1]], axis=1)
            + g("parked_events") - g("unparked_events")).all(),
        "offered_k == events_sent_k-1": (
            g("offered_events")[:, 1:] == stats["events_sent"][:, :-1]).all(),
        "offered == sent + deferred + dropped": (
            stats["offered"] == stats["events_sent"] + stats["deferred"]
            + stats["overflow"]).all(),
        "fresh events >= 0": (stats["offered"] - np.concatenate(
            [np.zeros((n_shards, 1), np.int64), stats["deferred"][:, :-1]],
            axis=1) - g("deferred_events") >= 0).all(),
        "latency histogram == delivered": (
            stats["latency.hist"].sum(-1) == g("delivered_events")).all(),
    }
    broken = [k for k, ok in checks.items() if not ok]
    if broken:
        raise AssertionError(f"{what}: identities broken: {broken}")


def check_torus_slice_small():
    """Card vs CPU for the window loop on the credited torus3d 2x2x2 at
    scale 0.004 over 8 shards, credits that bind: integer stats exact,
    floats within the LIF tolerances."""
    from repro_torch.convert import flatten
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    spec = mc.MicrocircuitSpec(scale=0.004)
    part = network.build_partition(*spec.weight_matrix(),
                                   n_shards=TORUS_SHARDS)
    cfg = sim_config(part, e_max=256, capacity=16, residue=64,
                     transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
                     link_credits=16, notify_latency=2)
    n_win = 8
    rng = np.random.default_rng(0)
    drive = torch.from_numpy(rng.poisson(
        1.3, (n_win, cfg.window, TORUS_SHARDS, cfg.per_shard)).astype(
            np.float32) * np.float32(87.8))
    out = {}
    for device in ("cpu", "cuda"):
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          device=device)
        st = init(0)
        if device == "cpu":
            v0 = st.neuron.v
        st = st._replace(neuron=st.neuron._replace(v=v0.to(device)),
                         generator=None)
        out[device] = run(st, n_win, drive=drive)
    require_same_outputs("torus slice card vs CPU", out["cuda"][1],
                         out["cpu"][1])
    st_cpu, st_gpu = out["cpu"][0], out["cuda"][0]
    np.testing.assert_allclose(st_gpu.neuron.v.cpu(), st_cpu.neuron.v,
                               rtol=2e-5, atol=1e-4)
    s = flatten(out["cpu"][1])
    check_backpressure_chain("torus slice", s, TORUS_SHARDS)
    stalls, parked = int(s["link.credit_stalls"].sum()), int(
        s["link.parked_events"].sum())
    if stalls == 0:
        raise AssertionError("torus slice: credits never bound")
    print(f"torus slice (scale 0.004, torus3d 2x2x2, credits 16, {n_win} "
          f"windows): card == CPU on every integer stat; {stalls} credit "
          f"stalls, {parked} events parked, {int(s['spikes'].sum())} spikes")


def run_torus_main_path():
    """The microcircuit at scale 0.2 over 8 wafer shards on the credited
    torus3d 2x2x2, 25 windows: with ample credits window for window equal
    to the crossbar's run of the same network, then with credits that
    bind."""
    from repro_torch.convert import flatten
    from repro_torch.core import events as ev
    from repro_torch.kernels import dispatch
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    t0 = time.perf_counter()
    spec = mc.MicrocircuitSpec(scale=SCALE)
    part = network.build_partition(*spec.weight_matrix(),
                                   n_shards=TORUS_SHARDS)
    if part.per_shard * part.fanout.shape[1] > ev.ADDR_MASK + 1:
        raise AssertionError("event addresses exceed the 14-bit field")
    print(f"partition: {TORUS_SHARDS} wafer shards x {part.per_shard} "
          f"neurons, max fan-out {part.fanout.shape[1]} shards/source; "
          f"built in {time.perf_counter() - t0:.1f} s")
    stats, launches = {}, {}
    for name, fields in TORUS_RUNS.items():
        cfg = sim_config(part, **{**dict(e_max=1024, capacity=1024,
                                         residue=256), **fields})
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          device="cuda")
        state = init(seed=0)
        run(state, 1)                 # warm-up (the same draws in every run)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t1 = time.perf_counter()
        state, st = run(state, N_WINDOWS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches[name] = dict(dispatch.LAUNCHES)
        stats[name] = flatten(st)
        s = stats[name]
        if not np.isfinite(state.neuron.v.cpu().numpy()).all():
            raise AssertionError(f"{name}: non-finite membrane potentials")
        can_defer = fields.get("link_credits", 0) > 0
        want = {"flush_window": N_WINDOWS,
                "wire_codec": N_WINDOWS + 1 + int(can_defer),
                "lif_step": N_WINDOWS}
        if can_defer:           # kernel F once per credited window
            want["admission"] = N_WINDOWS
        if fields["transport"] != "alltoall":
            # the ring rotation once per exchange and drain (each decoded)
            want["torus_exchange"] = want["wire_codec"]
        if launches[name] != want:
            raise AssertionError(f"{name}: launches {launches[name]} != "
                                 f"{want}")
        check_backpressure_chain(name, s, TORUS_SHARDS)
        ms = wall * 1e3 / N_WINDOWS
        print(f"{name}: {ms:.3f} ms per window ({N_WINDOWS} windows, host "
              f"clock); {int(s['spikes'].sum())} spikes, "
              f"{int(s['events_sent'].sum())} events sent, deadline misses "
              f"{int(s['deadline_miss'].sum())}, credit stalls "
              f"{int(s['link.credit_stalls'].sum())}, deferred "
              f"{int(s['link.deferred_events'].sum())}, parked "
              f"{int(s['link.parked_events'].sum())}, unparked "
              f"{int(s['link.unparked_events'].sum())}, hops per window "
              f"{int(s['link.hops'][0, -1])}, bytes on wire "
              f"{int(s['link.bytes_on_wire'].sum())}, latency p99 "
              f"{float(s['latency.p99_us'].max()):.2f} us; launches "
              f"{launches[name]}")
        if name.endswith("binding credits"):
            window_functions(run, state, 3)
            captured, _ = capture_admission(lambda: run(state, 8))
    base, ample = stats["alltoall"], stats["torus3d, ample credits"]
    binding = stats["torus3d, binding credits"]
    if int(base["spikes"].sum()) == 0:
        raise AssertionError("network is silent")
    for key in SAME_ON_EVERY_FABRIC:
        if not (ample[key] == base[key]).all():
            raise AssertionError(f"ample credits: {key} differs from the "
                                 f"alltoall run")
    if int(ample["deadline_miss"].sum()) != 0:
        raise AssertionError("ample credits: deadline misses")
    if int(binding["link.credit_stalls"].sum()) == 0:
        raise AssertionError("binding credits: no credit stall")
    print(f"ample credits == alltoall on {len(SAME_ON_EVERY_FABRIC)} "
          f"integer WindowStats fields in every window, 0 deadline misses; "
          f"binding credits: identities and residue chain exact, "
          f"{int(binding['deadline_miss'].sum())} deadline misses (model "
          f"output)")
    return launches["torus3d, binding credits"], captured, part, spec


# ---------------------------------------------------------------------------
# The fault phase: kernel F (the admission replay) and fault injection.
# ---------------------------------------------------------------------------

F_CREDITS, F_WINDOWS = 24, 8
F_TORI = (("torus2d 2x4", "torus2d", (2, 4)),
          ("torus3d 2x2x2", "torus3d", (2, 2, 2)))
# the chain's least time: each of its dependent steps (a row with work, of
# the 2 n^2) needs at least one shared-memory round trip, about 30 cycles
# on Hopper (microbenchmark papers: 29-33), at the H100 SXM's 1,980 MHz
# boost clock (data sheet)
SHARED_ROUND_TRIP_CYCLES = 30
SM_CLOCK_HZ = 1.98e9


# ---------------------------------------------------------------------------
# Main path 16: the full-scale microcircuit over a sparse synapse store.
# ---------------------------------------------------------------------------

FULL_RUNS = {
    "alltoall": dict(transport="alltoall"),
    # the full-scale benchmark cell's fabric: 124-event rows, a link's
    # credits one row, returned 4 windows after they are spent
    "torus3d, binding credits": dict(transport="torus3d", torus_nx=2,
                                     torus_ny=2, torus_nz=2,
                                     capacity=FULL_CELL_C,
                                     link_credits=FULL_CELL_C,
                                     notify_latency=4),
}


def full_scale_network():
    """The microcircuit example's network at full scale, built as the
    example builds it: ``MicrocircuitSpec.synapses`` drawn on the host,
    partitioned on the card over 8 shards in the source layout."""
    from repro_torch.examples import multiwafer_microcircuit as ex
    t0 = time.perf_counter()
    net = ex.build_network(FULL_SCALE, device="cuda")
    torch.cuda.synchronize()
    part = net.part
    if (part.n_shards, part.per_shard) != (FULL_SHARDS, FULL_PER):
        raise AssertionError(f"full scale: {part.n_shards} shards x "
                             f"{part.per_shard}, want {FULL_SHARDS} x "
                             f"{FULL_PER}")
    store_gb = sum(t.numel() * t.element_size() for t in part.store) / 1e9
    print(f"full scale: {net.spec.n_neurons} neurons, {net.n_synapses} "
          f"synapses, {part.n_shards} shards x {part.per_shard}, max "
          f"fan-out {part.fanout.shape[1]}; drawn and partitioned in "
          f"{time.perf_counter() - t0:.1f} s; store {store_gb:.2f} GB")
    return net


def _deliver_window(gen, S, C, per, t, fill):
    """One received window of the source layout for delivery at ``t``:
    (S, S, C) words whose addresses are local ids (1 in 64 past ``per``,
    which carries no synapse), timestamps from 3 steps late (deadline
    misses) to 30 ahead of ``t``, 10% with the valid bit clear, and (S, S)
    counts: ``fill`` "cell" 0-40 live a row (the full-scale cell delivers
    ~1,240 events a window), "full" every slot."""
    from repro_torch.core import events as ev
    dev = gen.device
    shape = (S, S, C)
    addr = torch.randint(0, per + per // 64, shape, generator=gen,
                         device=dev)
    slack = torch.randint(-3, 31, shape, generator=gen, device=dev)
    valid = torch.rand(shape, generator=gen, device=dev) < 0.9
    words = ev.pack(addr, (t + slack) & ev.TS_MASK, valid=valid)
    if fill == "full":
        counts = torch.full((S, S), C, dtype=torch.int32, device=dev)
    else:
        counts = torch.randint(0, 41, (S, S), generator=gen, device=dev,
                               dtype=torch.int32)
    return words, counts


def check_synapse_deliver(gen, part):
    """Delivery in event order (``kernels/synapse_deliver.py``) against its
    plain version on the card, on the same card tensors, at the full-scale
    cell's shapes: the full-scale store ``part`` (8 shards of 9,647, ~285 M
    synapses), rows of 124, rings of 32 slots; windows of the cell's load
    (0-40 live a row) and full rows (992 events a shard), at t 1,000, past
    the 15-bit timestamp wrap and past 2^16: both rings, the deadline
    misses and the store's counter bit for bit, one launch a call.  Its
    time (CUDA graph) at the cell's load against the bound of that
    window's synapses (8 B each: target and weight) and event words (4 B
    each), both counted in the run."""
    from repro_torch.kernels import dispatch, synapse_deliver as sd
    S, per, C, L = part.n_shards, part.per_shard, FULL_CELL_C, 32
    store = part.store
    dev = store.targets.device
    inh = torch.from_numpy(part.is_inh).to(dev)
    n_cases, sizes, timed = 0, {}, None
    for fill in ("cell", "full"):
        for t in (1000, (1 << 15) - 5, (1 << 16) + 7):
            words, counts = _deliver_window(gen, S, C, per, t, fill)
            rings = [torch.randn((L, S, per), generator=gen, device=dev)
                     * 50 for _ in range(2)]
            got, want = [r.clone() for r in rings], [r.clone() for r in rings]
            torch.cuda.synchronize()
            c0 = int(store.count)
            dispatch.reset_launches()
            miss = sd.synapse_deliver(*got, words, counts, t, store, inh,
                                      per)
            if dispatch.LAUNCHES != {"synapse_deliver": 1}:
                raise AssertionError(f"synapse_deliver: launches "
                                     f"{dispatch.LAUNCHES}, want one")
            c1 = int(store.count)
            miss_p = sd.synapse_deliver_plain(*want, words, counts, t,
                                              store, inh, per)
            n_syn, n_ev = c1 - c0, int(counts.sum())
            what = f"synapse_deliver {fill} t {t}"
            require_equal(what, [(got[0], want[0]), (got[1], want[1]),
                                 (miss, miss_p)])
            if int(store.count) - c1 != n_syn or n_syn == 0:
                raise AssertionError(f"{what}: the kernel counted {n_syn} "
                                     f"synapses, the plain version "
                                     f"{int(store.count) - c1}")
            if int(miss.sum()) == 0:
                raise AssertionError(f"{what}: no deadline miss tested")
            sizes[fill] = (n_syn, n_ev)
            n_cases += 1
            if timed is None:
                timed = (got, words, counts, t, n_syn, n_ev)
    got, words, counts, t, n_syn, n_ev = timed
    ms, eager_ms = time_ms(lambda: sd.synapse_deliver(
        *got, words, counts, t, store, inh, per))
    plain = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sd.synapse_deliver_plain(*got, words, counts, t, store, inh, per)
        end.record()
        end.synchronize()
        plain.append(start.elapsed_time(end))
    plain_ms = statistics.median(plain)
    bms, by = bound_ms(8 * n_syn + 4 * n_ev, n_syn)
    full_bms, _ = bound_ms(8 * sizes["full"][0] + 4 * sizes["full"][1],
                           sizes["full"][0])
    print(f"synapse_deliver at the full-scale cell's load: {n_ev} events, "
          f"{n_syn} synapses: kernel {ms:.4f} ms (CUDA graph), bound "
          f"{bms:.6f} ms ({by}), plain {plain_ms:.2f} ms (eager, one call); "
          f"full rows: {sizes['full'][1]} events, {sizes['full'][0]} "
          f"synapses, bound {full_bms:.6f} ms")
    return dict(name="synapse_deliver", route="cuda",
                source="src/repro_torch/csrc/synapse_deliver.cu",
                replaces="none: no TPU kernel (the reference delivers "
                         "through a dense weight matrix, "
                         "src/repro/snn/simulator.py:_apply_events)",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_ms,
                parity=f"bit-exact on both rings, the deadline misses and "
                       f"the synapse counter ({n_cases} cases: the "
                       f"full-scale store, the cell's load and full rows "
                       f"of 124, 3 times t); timed at the cell's load, the "
                       f"plain version eager")


def run_full_scale_path(net, smi: str) -> dict:
    """Main path 16: the full-scale network (``full_scale_network``) on
    the crossbar and on the full-scale cell's credited torus3d 2x2x2
    (``FULL_RUNS``), 25 windows each after a 1-window warm-up from seed-0
    potentials: launches counted from 0 just before each run (the flush
    window, the LIF window and kernel F once a window, delivery and the
    decode once an exchange and drain, the ring rotation with each decode
    on the torus), finite potentials, no deadline miss or overflow on the
    crossbar, the backpressure identities on the torus.  Returns the
    launches of both runs, summed."""
    from repro_torch.convert import flatten
    from repro_torch.kernels import dispatch
    from repro_torch.snn import simulator as sim
    part, spec = net.part, net.spec
    total = {}
    for name, fields in FULL_RUNS.items():
        cfg = sim_config(part, **{**dict(e_max=FULL_E_MAX,
                                         capacity=FULL_E_MAX,
                                         residue=256), **fields})
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          device="cuda")
        state = init(seed=0)
        run(state, 1)                 # warm-up (the same draws in both)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t1 = time.perf_counter()
        state, st = run(state, N_WINDOWS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(dispatch.LAUNCHES)
        s = flatten(st)
        can_defer = fields.get("link_credits", 0) > 0
        exchanges = N_WINDOWS + 1 + int(can_defer)
        want = {"flush_window": N_WINDOWS, "lif_step": N_WINDOWS,
                "wire_codec": exchanges, "synapse_deliver": exchanges}
        if can_defer:
            want["admission"] = N_WINDOWS
        if fields["transport"] != "alltoall":
            want["torus_exchange"] = exchanges
        if launches != want:
            raise AssertionError(f"full scale, {name}: launches {launches} "
                                 f"!= {want}")
        if not torch.isfinite(state.neuron.v).all():
            raise AssertionError(f"full scale, {name}: non-finite "
                                 f"membrane potentials")
        if can_defer:
            check_backpressure_chain(f"full scale, {name}", s, part.n_shards)
        elif int(s["deadline_miss"].sum()) or int(s["overflow"].sum()):
            raise AssertionError(f"full scale, {name}: deadline misses or "
                                 f"overflows on the crossbar")
        spikes = int(s["spikes"].sum())
        rate = spikes / (spec.n_neurons * N_WINDOWS * cfg.window
                         * cfg.params.dt * 1e-3)
        print(f"full scale, {name} [{smi}]: {wall * 1e3 / N_WINDOWS:.3f} ms "
              f"a window ({N_WINDOWS} windows and the final flush, host "
              f"clock); {spikes} spikes ({rate:.1f} Hz), offered {int(s['offered'].sum())}, sent "
              f"{int(s['events_sent'].sum())}, deferred "
              f"{int(s['deferred'].sum())}, dropped or lost "
              f"{int(s['overflow'].sum())}, "
              f"delivered {int(s['link.delivered_events'].sum())}, deadline "
              f"misses {int(s['deadline_miss'].sum())}; launches {launches}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


GRAPH_SEGMENTS = 6          # segments of 16 windows a turn of main path 17


def graph_loop_cells(part, bg_rates, full_part, full_bg_rates) -> list:
    """Main path 17's cells: (label, SimConfig, partition, background
    rates) of the three microcircuit benchmark cells' shapes, from the
    scale-0.2 dense partition and the full-scale sparse one."""
    cell = dict(transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
                capacity=FULL_CELL_C, link_credits=FULL_CELL_C,
                notify_latency=4)
    return [
        ("scale 0.2, torus3d c124", sim_config(
            part, e_max=1024, residue=256, **cell), part, bg_rates),
        ("scale 0.2, alltoall c1024", sim_config(
            part, e_max=1024, residue=256, transport="alltoall",
            capacity=1024), part, bg_rates),
        ("full scale, torus3d c124", sim_config(
            full_part, e_max=FULL_E_MAX, residue=256, **cell), full_part,
         full_bg_rates)]


def run_graph_loops(cells, smi: str) -> dict:
    """Main path 17 (module docstring) on ``graph_loop_cells``; returns
    the launches of one graph turn of each cell, summed."""
    from repro_torch.kernels import dispatch
    from repro_torch.snn import lif, network
    from repro_torch.snn import simulator as sim
    total = {}
    for label, cfg, part, bg_rates in cells:
        S, per, nw = cfg.n_shards, cfg.per_shard, 16
        init, run_segment, _ = sim.build_sharded_segments(
            cfg, part, bg_rates, device="cuda")
        _, _, body, _ = sim.make_pipeline_fns(
            cfg, device="cuda",
            sparse=isinstance(part, network.SparsePartition))
        wi = sim.window_inputs(cfg, part, bg_rates, device="cuda")
        c0 = init(0)
        c0 = c0._replace(state=c0.state._replace(generator=None))
        gen = torch.Generator(device="cuda").manual_seed(17)
        drives = [lif.poisson_input(wi.bg.expand(nw, cfg.window, S, per),
                                    87.8, cfg.params.dt, generator=gen)
                  for _ in range(GRAPH_SEGMENTS)]

        def eager():
            st0 = c0.state
            loop = (st0._replace(ring_exc=st0.ring_exc.clone(),
                                 ring_inh=st0.ring_inh.clone()),
                    c0.pending, c0.link)
            out = []
            for d in drives:
                rows = []
                for k in range(nw):
                    loop, st = body(loop, None, *wi[:4], d[k])
                    rows.append(st)
                out.append(sim.stack_windows(rows))
            return loop, out

        def graph():
            c, out = c0, []
            for d in drives:
                c, st = run_segment(c, nw, drive=d)
                out.append(st)
            return tuple(c)[:3], out

        eager()
        first_s = []                      # the first call, the capture
        for _ in range(2):
            t1 = time.perf_counter()
            run_segment(c0, nw, drive=drives[0])
            torch.cuda.synchronize()
            first_s.append(time.perf_counter() - t1)
        sim.reset_segments()
        results, ms = {}, {"eager": [], "graph": []}
        for name in ("eager", "graph", "graph", "eager"):
            dispatch.reset_launches()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            res = (eager if name == "eager" else graph)()
            b.record()
            torch.cuda.synchronize()
            ms[name].append(a.elapsed_time(b) / (nw * GRAPH_SEGMENTS))
            results.setdefault(name, (res, dispatch.launch_counts()))
        (want, want_l), (got, got_l) = results["eager"], results["graph"]
        n_equal = 0
        for x, y in zip(sim.tensors_of((got[0], *got[1])),
                        sim.tensors_of((want[0], *want[1])), strict=True):
            if not torch.equal(x, y):
                raise AssertionError(f"window loop, {label}: the graph's "
                                     f"turn differs from the eager turn")
            n_equal += 1
        if got_l != want_l:
            raise AssertionError(f"window loop, {label}: launches {got_l} "
                                 f"!= the eager loop's {want_l}")
        if sim.SEGMENTS != {"eager": 0, "replayed": 2 * GRAPH_SEGMENTS,
                            "captured": 0}:
            raise AssertionError(f"window loop, {label}: segments "
                                 f"{sim.SEGMENTS}")
        fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
        print(f"window loop, {label} [{smi}]: ms a window (CUDA events, "
              f"{GRAPH_SEGMENTS} x {nw} windows a turn, turns eager, "
              f"graph, graph, eager): eager {fmt(ms['eager'])}, graph "
              f"{fmt(ms['graph'])}; segments {dict(sim.SEGMENTS)}; "
              f"{n_equal} tensors equal bit for bit; launches a turn "
              f"{got_l[0]}; host s of run_segment's first call (eager) "
              f"{first_s[0]:.3f}, of its capture {first_s[1]:.3f}")
        for k, n in got_l[0].items():
            total[k] = total.get(k, 0) + n
    return total


# ---------------------------------------------------------------------------
# Main path 18: NEST's HPC benchmark network at the HPC cell's scale.
# ---------------------------------------------------------------------------

HPC_SCALE = 8                  # 8 shards of 11,250: one benchmark unit each
HPC_SHARDS = 8
HPC_PER = 11250
HPC_CELL = dict(transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
                capacity=FULL_CELL_C, link_credits=4096, notify_latency=4)
HPC_E_MAX = 4096               # the HPC cell's e_max
HPC_SEGMENTS = 4               # segments of 16 windows of main path 18


def hpc_network():
    """The HPC benchmark network at the cell's scale, drawn and
    partitioned on the card as ``examples/hpc_benchmark.py`` does: 90,000
    neurons, in-degree 9,000 + 2,250 with multapses, ~1.01 B synapses of
    which 648 M plastic E->E.  -> (spec, partition)."""
    from repro_torch.snn import hpc_benchmark as hb, network
    t0 = time.perf_counter()
    spec = hb.HpcSpec(scale=HPC_SCALE)
    src = spec.draw_sources(torch.Generator(device="cuda").manual_seed(0))
    part = network.build_indegree_partition(
        src, spec.is_inh(), HPC_SHARDS, spec.je_pa, spec.ji_pa,
        hb.STDP.delay_steps)
    del src
    torch.cuda.synchronize()
    if (part.n_shards, part.per_shard) != (HPC_SHARDS, HPC_PER) or \
            not part.store.multapses:
        raise AssertionError(f"HPC network: {part.n_shards} shards x "
                             f"{part.per_shard}, multapses "
                             f"{part.store.multapses}; want {HPC_SHARDS} x "
                             f"{HPC_PER} with multapses")
    n_plastic = int(part.plastic.targets.numel())
    print(f"HPC network: {spec.n_neurons} neurons, {part.n_synapses} static "
          f"and {n_plastic} plastic synapses, {part.n_shards} shards x "
          f"{part.per_shard}, longest plastic list {part.plastic.longest}; "
          f"drawn and partitioned in {time.perf_counter() - t0:.1f} s")
    return spec, part


def _hpc_archive(gen, S, per, H, t):
    """Post-spike archives at step ``t``: counts 0 to 3H (past H: entries
    overwritten), each neuron's kept steps ascending before ``t``, 1 in 16
    neurons spiking every 1-10 steps (walks that reach past the oldest
    kept entry) and the rest every 1-2,000 (~7.8 Hz, the cell's rate), K-
    in [1, 4).  -> (count, step, kminus)."""
    dev = gen.device
    count = torch.randint(0, 3 * H, (S, per), generator=gen, device=dev,
                          dtype=torch.int32)
    fast = torch.rand((S, per, 1), generator=gen, device=dev) < 1 / 16
    gaps = 1 + (torch.rand((S, per, H), generator=gen, device=dev)
                * torch.where(fast, 10.0, 2000.0)).long()
    age = torch.flip(torch.cumsum(torch.flip(gaps, [-1]), -1), [-1])
    # entry n % H holds spike n: the newest (count - 1) is the youngest
    n = count.long()[..., None] - H + torch.arange(H, device=dev)
    steps = (t - age).int()                    # oldest kept spike first
    slot = torch.remainder(n, H)
    step = torch.zeros((S, per, H), dtype=torch.int32, device=dev)
    step.scatter_(-1, slot, steps)
    km = 1 + 3 * torch.rand((S, per, H), generator=gen, device=dev)
    return count, step, km


def check_lif_alpha(gen, S: int, per: int):
    """Kernel C's alpha form (``lif_alpha_window``) at the HPC cell's
    neurons (8 x 11,250, windows of 8 steps off a 32-slot ring): 6 chained
    windows with the post-spike archive (t0 from 4,000, so the ring
    wraps; even windows by value, odd ones through the step pointer),
    archives past H so entries wrap, then 2 windows without the archive
    (by value and by pointer); state, raster, rings and archive bit for
    bit against ``lif_alpha_window_plain`` on the same card tensors, one
    launch a call, spikes and refractory neurons exercised.  Its time
    (CUDA graph) with the archive against the bound of the HPC cell's
    roofline count (``gpubench/rooflines/lif_alpha_window.py``) on that
    window's spikes."""
    from repro_torch.kernels import dispatch, lif_step as ls
    from repro_torch.snn import hpc_benchmark as hb, lif
    dev = gen.device
    p, W, L, H = hb.PARAMS, 8, 32, hb.STDP.history
    shape = (S, per)
    u = lambda *s: torch.rand(s or shape, generator=gen, device=dev)
    minus = lif.decay_table(p.dt, hb.STDP.tau_minus, dev)
    state = lif.AlphaState(
        p.e_l + (p.v_th - p.e_l + 2.0) * u(), u() * 400.0, u() * 60.0,
        -u() * 900.0, -u() * 100.0,
        torch.randint(0, 6, shape, generator=gen, device=dev,
                      dtype=torch.int32))
    t0 = 4000
    count, step, km = _hpc_archive(gen, S, per, H, t0)
    archive = lif.PostArchive(step, km, count.clone())
    spikes, err = 0, 0.0

    def window(st, t, by_pointer, ar):
        nonlocal err
        re, ri = u(L, *shape) * 300.0, -u(L, *shape) * 200.0
        drive = torch.poisson(u(W, *shape) * 4.0, generator=gen) \
            * hb.HpcSpec().je_pa
        rings, plain_rings = (re.clone(), ri.clone()), (re, ri)
        ar_k = None if ar is None else lif.PostArchive(
            *(x.clone() for x in ar))
        at = torch.tensor([t], dtype=torch.int32, device=dev) \
            if by_pointer else t
        dispatch.reset_launches()
        got, gsp = ls.lif_alpha_window(st, p, *rings, at, drive,
                                       archive=ar_k,
                                       minus_table=None if ar is None
                                       else minus)
        if dispatch.LAUNCHES != {"lif_alpha": 1}:
            raise AssertionError(f"lif_alpha_window: launches "
                                 f"{dispatch.LAUNCHES}, want one")
        want, wsp = ls.lif_alpha_window_plain(st, p, *plain_rings, t, drive,
                                              archive=ar,
                                              minus_table=None if ar is None
                                              else minus)
        pairs = (list(zip(got, want)) + [(gsp, wsp)]
                 + list(zip(rings, plain_rings))
                 + ([] if ar is None else list(zip(ar_k, ar))))
        require_equal(f"lif_alpha_window t0 {t}"
                      f"{' by pointer' if by_pointer else ''}"
                      f"{'' if ar is not None else ', no archive'}", pairs)
        err = max(err, max_abs_err(pairs))
        return got, int(gsp.sum())

    for k in range(6):
        state, n = window(state, t0 + k * W, k % 2 == 1, archive)
        spikes += n
    appended = int((archive.count - count).sum())
    for by_pointer in (False, True):
        state, n = window(state, t0 + (6 + by_pointer) * W, by_pointer,
                          None)
        spikes += n
    if spikes == 0 or appended == 0 or int((state.refrac > 0).sum()) == 0 \
            or int((archive.count >= H).sum()) == 0:
        raise AssertionError("lif_alpha_window: threshold, refractory, "
                             "archive or archive wrap unexercised")

    re, ri = u(L, *shape) * 300.0, -u(L, *shape) * 200.0
    drive = torch.poisson(u(W, *shape) * 4.0, generator=gen) \
        * hb.HpcSpec().je_pa
    t_win = t0 + 8 * W
    _, raster = ls.lif_alpha_window(state, p, re.clone(), ri.clone(), t_win,
                                    drive, archive=lif.PostArchive(
                                        *(x.clone() for x in archive)),
                                    minus_table=minus)
    n_spikes = int(raster.sum())
    ms, eager_ms = time_ms(lambda: ls.lif_alpha_window(
        state, p, re, ri, t_win, drive, archive=archive, minus_table=minus))
    plain = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        ls.lif_alpha_window_plain(state, p, re, ri, t_win, drive,
                                  archive=archive, minus_table=minus)
        b.record()
        b.synchronize()
        plain.append(a.elapsed_time(b))
    plain_ms = statistics.median(plain)
    n = S * per
    # the HPC cell's roofline count: state 24 + 24 B, the archive's count
    # and newest entry 16 B, per step 21 B, per spike an 8-B entry
    n_bytes = n * (24 + 24 + 16 + W * (12 + 8 + 1)) + 8 * n_spikes
    bms, by = bound_ms(n_bytes, n * 25 * W)
    print(f"lif_alpha_window at the HPC cell's neurons ({n}, {W} steps, "
          f"{n_spikes} spikes in the timed window): kernel {ms:.4f} ms "
          f"(CUDA graph), bound {bms:.6f} ms ({by}, {n_bytes} B), plain "
          f"{plain_ms:.3f} ms (eager, one call); eager call {eager_ms:.4f} "
          f"ms")
    return dict(name="lif_alpha", route="cuda",
                source="src/repro_torch/csrc/lif_step.cu",
                replaces="none: no TPU kernel (the reference has only "
                         "iaf_psc_exp, src/repro/snn/lif.py)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_ms,
                parity=f"bit-exact on state, raster, rings and archive (6 "
                       f"chained {W}-step windows with the archive, by value "
                       f"and by step pointer, archives past H = {H}, "
                       f"{appended} spikes appended; 2 windows without it; "
                       f"{spikes} spikes); timed with the archive")


def _hpc_window(gen, S, per, C, t, fill):
    """One received window of the HPC cell at step ``t``: (S, S, C) words
    of local ids (each 7th slot repeating its row's first source), slack
    from 2 steps late to 15 ahead, and (S, S) counts: ``fill`` "cell"
    40-100 live a row (the cell's ~70 and its bursts), "full" every
    slot."""
    from repro_torch.core import events as ev
    dev = gen.device
    addr = torch.randint(0, per, (S, S, C), generator=gen, device=dev)
    addr[:, :, ::7] = addr[:, :, :1]
    slack = torch.randint(-2, 16, (S, S, C), generator=gen, device=dev)
    words = ev.pack(addr, (t + slack) & ev.TS_MASK)
    counts = (torch.full((S, S), C, dtype=torch.int32, device=dev)
              if fill == "full" else
              torch.randint(40, 101, (S, S), generator=gen, device=dev,
                            dtype=torch.int32))
    return words, counts


def check_hpc_deliver(gen, part):
    """Kernel S at the HPC cell's load, over the scale-8 store
    (``hpc_network``): its multapse instance (``synapse_deliver`` on a
    ``MultapseStore``) and then its plastic form (``stdp_deliver``: plan,
    update, plastic walk) against ``synapse_deliver_plain`` and
    ``stdp_deliver_plain`` on the same card tensors, rows of 124, rings of
    32: a window at the cell's load (40-100 live a row) at t 4,000 and a
    full-row window 8 steps later on the state the first left; archives
    past H, traces and last spikes drawn, repeated sources and missed
    events; rings, misses, the store's counter, plastic weights, traces,
    last spikes and counters bit for bit, one launch of each a window.
    Times (CUDA graph) of the multapse walk and the plastic form at the
    cell's load against their bounds from that window's counters: 8 B a
    static add and 4 B an event word; 12 B a plastic update, 8 B an
    archive entry read and 4 B an event word (``gpubench/rooflines/
    stdp_deliver.py``'s count).  -> (the plastic form's record, the
    multapse walk's parity and times)."""
    from repro_torch.kernels import dispatch, synapse_deliver as sd
    from repro_torch.snn import hpc_benchmark as hb, lif, stdp
    S, per, C, L = part.n_shards, part.per_shard, FULL_CELL_C, 32
    dev = gen.device
    sp = hb.STDP
    store, lists = part.store, part.plastic
    inh = torch.from_numpy(part.is_inh).to(dev)
    tables = tuple(lif.decay_table(hb.PARAMS.dt, tau, dev)
                   for tau in (sp.tau_plus, sp.tau_minus))
    t0 = 4000
    count, step, km = _hpc_archive(gen, S, per, sp.history, t0)
    state = stdp.init_plastic(part.plastic_weights, S, per, sp)._replace(
        archive=lif.PostArchive(step, km, count))
    n_ids = S * per
    state = state._replace(
        kplus=torch.rand((S, n_ids), generator=gen, device=dev) * 3,
        t_last=torch.randint(-1, t0 - 10, (S, n_ids), generator=gen,
                             device=dev, dtype=torch.int32))
    plain_state = stdp.clone(state)
    sizes, plain_ms = {}, {}
    for t, fill in ((t0, "cell"), (t0 + 8, "full")):
        words, counts = _hpc_window(gen, S, per, C, t, fill)
        rings = [torch.randn((L, S, per), generator=gen, device=dev) * 50
                 for _ in range(2)]
        plain = [r.clone() for r in rings]
        torch.cuda.synchronize()
        c0, u0 = int(store.count), state.counts.sum(0).tolist()
        dispatch.reset_launches()
        miss = sd.synapse_deliver(*rings, words, counts, t, store, inh, per)
        sd.stdp_deliver(*rings, words, counts, t, lists, state, inh, per,
                        sp, tables)
        if dispatch.LAUNCHES != {"synapse_deliver": 1, "stdp_deliver": 1}:
            raise AssertionError(f"HPC delivery: launches "
                                 f"{dispatch.LAUNCHES}, want one each")
        c1, u1 = int(store.count), state.counts.sum(0).tolist()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        miss_p = sd.synapse_deliver_plain(*plain, words, counts, t, store,
                                          inh, per)
        sd.stdp_deliver_plain(*plain, words, counts, t, lists, plain_state,
                              inh, per, sp, tables)
        b.record()
        b.synchronize()
        plain_ms[fill] = a.elapsed_time(b)
        what = f"HPC delivery {fill} t {t}"
        require_equal(what, [(rings[0], plain[0]), (rings[1], plain[1]),
                             (miss, miss_p)] + [
            (x, y) for f, x, y in zip(stdp.PlasticState._fields, state,
                                      plain_state) if f != "archive"])
        if int(store.count) - c1 != c1 - c0:
            raise AssertionError(f"{what}: the kernel counted {c1 - c0} "
                                 f"static adds, the plain version "
                                 f"{int(store.count) - c1}")
        d = [y - x for x, y in zip(u0, u1)]
        if int(miss.sum()) == 0 or d[0] == 0 or d[1] == 0 or d[3] == 0:
            raise AssertionError(f"{what}: misses {int(miss.sum())}, "
                                 f"counters {d}: a path unexercised")
        sizes[fill] = dict(static=c1 - c0, events=int(counts.sum()),
                           counters=dict(zip(stdp.COUNTERS, d)),
                           operands=(words, counts, t))
    words, counts, t = sizes["cell"]["operands"]
    rings = [torch.zeros((L, S, per), device=dev) for _ in range(2)]
    walk_ms, walk_eager = time_ms(lambda: sd.synapse_deliver(
        *rings, words, counts, t, store, inh, per))
    ms, eager_ms = time_ms(lambda: sd.stdp_deliver(
        *rings, words, counts, t, lists, state, inh, per, sp, tables))
    z = sizes["cell"]
    walk_bms, walk_by = bound_ms(8 * z["static"] + 4 * z["events"],
                                 z["static"])
    n_bytes = (12 * z["counters"]["updates"]
               + 8 * z["counters"]["entries_read"] + 4 * z["events"])
    bms, by = bound_ms(n_bytes, 0)
    print(f"HPC delivery at the cell's load: {z['events']} events, "
          f"{z['static']} static adds, counters {z['counters']}; multapse "
          f"walk {walk_ms:.4f} ms (CUDA graph), bound {walk_bms:.6f} ms "
          f"({walk_by}); plastic form {ms:.4f} ms, bound {bms:.6f} ms "
          f"({by}, {n_bytes} B); plain (both, eager, one call) "
          f"{plain_ms['cell']:.0f} ms; full rows: {sizes['full']['events']} "
          f"events, {sizes['full']['static']} static adds, counters "
          f"{sizes['full']['counters']}")
    record = dict(name="stdp_deliver", route="cuda",
                  source="src/repro_torch/csrc/synapse_deliver.cu",
                  replaces="none: no TPU kernel (the reference has no "
                           "plastic synapse)",
                  max_abs_err=0.0, ms=ms, plain_ms=plain_ms["cell"],
                  bound_ms=bms, bound_by=by, library_ms=None,
                  eager_ms=eager_ms, plain_eager_ms=plain_ms["cell"],
                  parity=f"bit-exact after the multapse walk on both rings, "
                         f"the misses, the store's counter, the plastic "
                         f"weights, traces, last spikes and counters (the "
                         f"scale-8 store, a window at the cell's load and a "
                         f"full-row window chained, archives past H); "
                         f"timed at the cell's load, the plain version "
                         f"eager (with the multapse walk)")
    walk = (f"; its multapse instance bit-exact over the HPC cell's "
            f"scale-8 store (a window at the cell's load and a full-row "
            f"window), {walk_ms:.4f} ms at the cell's load against a bound "
            f"of {walk_bms:.6f} ms ({walk_by})")
    return record, walk


def run_hpc_path(spec, part, smi: str) -> dict:
    """Main path 18: the HPC network (``hpc_network``) through
    ``build_sharded_segments`` with ``snn.hpc_benchmark.STDP`` on the HPC
    cell's fabric (torus3d 2x2x2, 124-event rows, 4,096 credits, notify
    4, e_max 4,096), from potentials drawn from N(5.7, 7.2) mV and the
    Poisson drive at the script's rate: ``HPC_SEGMENTS`` segments of 16
    windows (the first eager, the second captured, the rest replayed),
    launches counted from 0 before the replayed ones (the flush window,
    the alpha LIF window, F, H's rotation, the decode, the multapse walk
    and the plastic form once a window), finite potentials, the
    backpressure identities over all the segments, plastic updates made
    and ``history_short`` 0 in the replayed ones; ms a window of the
    replayed segments (CUDA events).  Returns the
    replayed segments' launches."""
    from repro_torch.convert import flatten
    from repro_torch.kernels import dispatch
    from repro_torch.snn import hpc_benchmark as hb, lif, stdp
    from repro_torch.snn import simulator as sim
    cfg = sim_config(part, e_max=HPC_E_MAX, residue=256, params=hb.PARAMS,
                     **HPC_CELL)
    S, per, nw = cfg.n_shards, cfg.per_shard, 16
    rate = np.full(spec.n_neurons, spec.drive_rate_hz(), np.float32)
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, part, rate, spec.je_pa, device="cuda", stdp=hb.STDP)
    gen = torch.Generator(device="cuda").manual_seed(3)
    c = init(0)
    v0 = hb.V0_MEAN + hb.V0_SD * torch.randn((S, per), generator=gen,
                                             device="cuda")
    c = c._replace(state=c.state._replace(
        neuron=c.state.neuron._replace(v=v0), generator=None))
    bg = torch.full((nw, cfg.window, S, per), spec.drive_rate_hz(),
                    device="cuda")
    drive = lambda: lif.poisson_input(bg, spec.je_pa, cfg.params.dt,
                                      generator=gen)
    stats = []
    for _ in range(2):                  # eager, then the capture
        c, st = run_segment(c, nw, drive=drive())
        stats.append(st)
    torch.cuda.synchronize()
    sim.reset_segments()
    dispatch.reset_launches()
    counts0 = c.plastic.counts.sum(0)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(HPC_SEGMENTS - 2):
        c, st = run_segment(c, nw, drive=drive())
        stats.append(st)
    b.record()
    torch.cuda.synchronize()
    n = (HPC_SEGMENTS - 2) * nw
    ms = a.elapsed_time(b) / n
    launches = dict(dispatch.LAUNCHES)
    want = {k: n for k in ("flush_window", "lif_alpha", "wire_codec",
                           "synapse_deliver", "stdp_deliver", "admission",
                           "torus_exchange")}
    if launches != want:
        raise AssertionError(f"HPC path: launches {launches} != {want}")
    if sim.SEGMENTS != {"eager": 0, "replayed": HPC_SEGMENTS - 2,
                        "captured": 0}:
        raise AssertionError(f"HPC path: segments {sim.SEGMENTS}")
    if not torch.isfinite(c.state.neuron.v).all():
        raise AssertionError("HPC path: non-finite membrane potentials")
    flat = [flatten(st) for st in stats]
    s = {k: np.concatenate([f[k] for f in flat], axis=1) for k in flat[0]}
    check_backpressure_chain("HPC path", s, S)
    d = dict(zip(stdp.COUNTERS, (c.plastic.counts.sum(0)
                                 - counts0).tolist()))
    if d["updates"] == 0 or d["history_short"] != 0:
        raise AssertionError(f"HPC path: plastic counters {d}")
    spikes = int(s["spikes"][:, -n:].sum())
    hz = spikes / (spec.n_neurons * n * cfg.window * cfg.params.dt * 1e-3)
    w = c.plastic.weights
    r = lambda k: int(s[k][:, -n:].sum())
    print(f"HPC path [{smi}]: {ms:.4f} ms a window ({n} replayed windows, "
          f"CUDA events); {spikes} spikes ({hz:.2f} Hz), offered "
          f"{r('offered')}, dropped or lost {r('overflow')}, delivered "
          f"{r('link.delivered_events')}, deadline misses "
          f"{r('deadline_miss')}; plastic {d}; E->E weights "
          f"{float(w.mean()):.4f} +- {float(w.std()):.4f}; launches "
          f"{launches}")
    return launches


def capture_admission(fn, wrappers=("admission",), every: int = 1):
    """Run ``fn`` with every ``every``-th call of the admission wrappers
    ``wrappers`` recorded (``admission``; for the tenant transport both
    ``admission_tenants`` and ``admission_tenants_blocks``, which its
    healthy credited windows on the card call): -> ([(call index, counts,
    FabricState, RouteTables, link_down)], each tensor a copy; ``fn``'s
    result)."""
    from repro_torch.kernels import admission
    reals, calls, seen = {w: getattr(admission, w) for w in wrappers}, [], [0]

    def spy(real):
        def call(counts, state, tables, link_down=None, **kw):
            if seen[0] % every == 0:
                copy = lambda t: None if t is None else t.clone()
                calls.append((seen[0], counts.clone(), type(state)(*(
                    type(x)(*map(copy, x)) if hasattr(x, "_fields")
                    else copy(x) for x in state)), tables, copy(link_down)))
            seen[0] += 1
            return real(counts, state, tables, link_down, **kw)
        return call

    for w, real in reals.items():
        setattr(admission, w, spy(real))
    try:
        out = fn()
    finally:
        for w, real in reals.items():
            setattr(admission, w, real)
    torch.cuda.synchronize()
    return calls, out


def check_stall_lane(what, got, counts):
    """The stall lane sums to the window's deferred events."""
    deferred = int(torch.where(got.stall_hop >= 0, counts, 0).sum())
    if int(got.stalled_by_link.sum()) != deferred:
        raise AssertionError(f"{what}: stalled_by_link sums to "
                             f"{int(got.stalled_by_link.sum())}, the window "
                             f"deferred {deferred}")


def plain_single(counts, state, tables, down=None, **kw):
    """The plain replay of a single-tenant window on its operands' device:
    the fabric as one tenant with reserve 0, as ``admission`` runs it on
    CPU tensors."""
    from repro_torch.kernels import admission as adm
    K = counts.shape[0] * 2 * tables.seg.shape[0]
    return adm._single_tenant(adm.admission_tenants_plain(
        *adm._one_tenant(counts, state), tables, down, **kw), K)


def check_admission_case(what, counts, state, tables, down):
    """Kernel F against the plain replay on one window, every field and the
    stall lane (``stall_lane=True`` on both): with no mask against the
    healthy replay, and with an all-false mask against the healthy and the
    masked replay; with a mask against the masked replay."""
    from repro_torch.kernels import admission as adm
    got = adm.admission(counts, state, tables, down, stall_lane=True)
    check_stall_lane(what, got, counts)
    if down is None:
        plain = plain_single(counts, state, tables, stall_lane=True)
        require_equal(f"{what}: kernel F vs the healthy replay",
                      list(zip(got, plain)))
        off = torch.zeros_like(state.parked_by_link, dtype=torch.bool)
        masked = adm.admission(counts, state, tables, off, stall_lane=True)
        for name, want in (("healthy", plain), ("masked", plain_single(
                counts, state, tables, off, stall_lane=True))):
            require_equal(f"{what}: kernel F, all-false mask, vs the "
                          f"{name} replay", list(zip(masked, want)))
        return got
    require_equal(f"{what}: kernel F vs the masked replay",
                  list(zip(got, plain_single(counts, state, tables, down,
                                             stall_lane=True))))
    return got


def fault_schedules(dims, n_win, device, chaos_seeds=()):
    """benchmarks/bench_microcircuit.py:48-54's four schedules (faults from
    window 2: none, a dead cable, a flapping one, a dropped node), then
    ``chaos`` for each of ``chaos_seeds``."""
    from repro_torch.fabric import faults
    out = {"none": faults.healthy(dims, n_win, device=device),
           "link_down": faults.link_fault(dims, n_win, 0, 0, start=2,
                                          device=device),
           "link_flap": faults.link_flap(dims, n_win, 0, 0, period=2,
                                         start=2, device=device),
           "node_down": faults.node_fault(dims, n_win, 3, start=2,
                                          device=device)}
    for seed in chaos_seeds:
        out[f"chaos {seed}"] = faults.chaos(dims, n_win, seed, device=device)
    return out


def _fault_transport_run(backend, dims, sched, seed, device):
    """8 windows of one transport under ``sched``, traffic from
    ``traffic_rng(seed)``: -> [(counts, state before, mask, out)]."""
    from repro_torch import transport as tp
    from repro_torch.fabric import faults
    from repro_torch.serve.loadgen import draw_counts, draw_payload, \
        traffic_rng
    n = int(np.prod(dims))
    tb = tp.create(backend, n_shards=n, link_credits=F_CREDITS,
                   notify_latency=2, max_row_events=F_CREDITS,
                   **dict(zip(("nx", "ny", "nz"), dims)))
    rng = traffic_rng(seed)
    state = tb.init_state(4, device=device)
    rows = []
    for w in range(F_WINDOWS):
        counts = torch.from_numpy(draw_counts(rng, (n, n), F_CREDITS)).to(
            device)
        payload = torch.from_numpy(draw_payload(rng, (n, n, 4)).view(
            np.int32)).to(device)
        down = faults.mask_at(sched, w)
        out = tb.exchange(state._replace(link_down=down), payload, counts)
        rows.append((counts, state, down, out))
        state = out.state
    return tb, rows


def check_admission(captured):
    """Kernel F against the plain replay, bit for bit on every field: on
    the healthy states captured from main path 3's binding-credit run, and
    on transport runs of 8 windows under the fault matrix's schedules and
    chaos seeds 0-4 on torus2d 2x4 and torus3d 2x2x2 (credits 24, traffic
    from traffic_rng / draw_counts), each also card == CPU; then times
    kernel F and the plain replay on a captured state."""
    from repro_torch.convert import flatten
    from repro_torch.kernels import admission as adm
    cases = 0
    for i, counts, state, tables, down in captured:
        if down is not None:
            raise AssertionError("main path 3 stamped a fault mask")
        check_admission_case(f"main path 3 window {i}", counts, state,
                             tables, None)
        cases += 1
    seen = dict(rerouted=0, hop0=0, parked=0, deferred=0, stalled=0)
    for label, backend, dims in F_TORI:
        scheds = {d: fault_schedules(dims, F_WINDOWS, d, range(5))
                  for d in ("cuda", "cpu")}
        for k, (name, sched) in enumerate(scheds["cuda"].items()):
            tb, rows = _fault_transport_run(backend, dims, sched, k, "cuda")
            tables = tb._dev(torch.device("cuda"))["routes"]
            for w, (counts, state, down, out) in enumerate(rows):
                got = check_admission_case(f"{label} {name} window {w}",
                                           counts, state, tables, down)
                seen["rerouted"] += int(got.rerouted.sum())
                seen["hop0"] += int(((got.park_count > 0)
                                     & (got.park_hop == 0)).sum())
                seen["parked"] += int(got.fresh_park.sum())
                seen["deferred"] += int((got.stall_hop >= 0).sum())
                seen["stalled"] += int(got.stalled_by_link.sum())
                cases += 1
            _, cpu = _fault_transport_run(backend, dims,
                                          scheds["cpu"][name], k, "cpu")
            for w, (g, c) in enumerate(zip(rows, cpu)):
                require_same_outputs(f"{label} {name} window {w} card vs "
                                     f"CPU", g[3], c[3])
    if not all(seen.values()):
        raise AssertionError(f"admission cases exercised too little: {seen}")
    _, counts, state, tables, _ = captured[-1]
    n = counts.shape[0]
    ms, eager_ms = time_ms(lambda: adm.admission(counts, state, tables))
    lane_ms, lane_eager_ms = time_ms(lambda: adm.admission(
        counts, state, tables, stall_lane=True))
    healthy_ms = time_loop(lambda: plain_single(counts, state, tables))
    off = torch.zeros_like(state.parked_by_link, dtype=torch.bool)
    faulted_ms = time_loop(lambda: plain_single(counts, state, tables, off))
    # without a mask the kernel reads only combo 0 of the route tables and
    # never the axis segments
    n_bytes = (sum(x.numel() * x.element_size() for x in (
        counts, state.parked_count, state.parked_hop, state.parked_age,
        state.bank.credits, state.bank.epoch, state.parked_by_link,
        tables.seq_alt[0], tables.len_alt[0]))
        + sum(x.numel() * x.element_size()
              for x in adm.admission(counts, state, tables)
              if x is not None))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    # the chain this input needs: a parked row to resume, or an off-diagonal
    # fresh row with events; every other row (a local one has no links, an
    # empty one spends, notifies and holds nothing) is decided in parallel
    eye = torch.eye(n, dtype=torch.bool, device=counts.device)
    steps = int((state.parked_count > 0).sum()) + int(
        ((counts > 0) & ~eye).sum())
    t_chain = steps * SHARED_ROUND_TRIP_CYCLES / SM_CLOCK_HZ * 1e3
    bms, by = max((t_bytes, "bytes"), (t_chain, "operations"))
    print(f"admission: {cases} windows bit for bit against the plain "
          f"replay ({seen}); at main path 3's shape (8 shards, 48 links): "
          f"kernel {ms:.4f} ms (CUDA graph), eager {eager_ms:.4f} ms; the "
          f"plain replay {healthy_ms:.3f} ms healthy and {faulted_ms:.3f} "
          f"ms under an all-false mask a call (eager, events around 5 "
          f"calls); bound {bms:.6f} ms "
          f"({'the chain: ' if by == 'operations' else ''}"
          f"{steps} dependent steps of {2 * n * n} rows x "
          f"{SHARED_ROUND_TRIP_CYCLES} cycles at "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz = {t_chain:.6f} ms; {n_bytes} B = "
          f"{t_bytes:.6f} ms); with the stall lane: kernel {lane_ms:.4f} ms "
          f"(CUDA graph), eager {lane_eager_ms:.4f} ms, in the same call")
    return dict(name="admission", route="cuda",
                source="src/repro_torch/csrc/admission.cu",
                replaces="none: no TPU kernel (the reference replays with "
                         "lax.scan, src/repro/transport/torus.py:387 and "
                         ":528)",
                max_abs_err=0.0, ms=ms, plain_ms=healthy_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=healthy_ms, faulted_loop_ms=faulted_ms,
                lane_ms=lane_ms,
                parity=f"bit-exact ({cases} windows, the plain replay "
                       f"healthy and masked, the stall lane included)")


def time_loop(fn, calls: int = 5) -> float:
    """ms per call of a plain loop, eager: CUDA events around ``calls``
    calls after one warm-up (its cost is its launches, so no graph)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def run_fault_matrix(part, spec):
    """The fault matrix of benchmarks/bench_microcircuit.py at main path
    3's width: the scale-0.2 microcircuit over 8 shards on torus3d 2x2x2
    with its binding credits, 25 windows, one drive for every schedule.
    A timed run of the 25 windows and their drain; then the same windows
    one by one, their WindowStats equal to the timed run's: conservation,
    the credit identity, nothing spent or held on a dead link once its mask
    lands; detours where a cable dies; the drain
    empties the fabric; the healthy schedule equals the run without one.
    Then device functions per window (torch.profiler)."""
    from repro_torch import transport as tp
    from repro_torch.convert import flatten
    from repro_torch.fabric import faults
    from repro_torch.kernels import dispatch
    from repro_torch.snn import lif
    from repro_torch.snn import simulator as sim
    fields = TORUS_RUNS["torus3d, binding credits"]
    cfg = sim_config(part, **{**dict(e_max=1024, capacity=1024,
                                     residue=256), **fields})
    limit = cfg.link_credits
    gen = torch.Generator(device="cuda").manual_seed(7)
    per, S = part.per_shard, TORUS_SHARDS
    bg = torch.from_numpy(np.pad(spec.bg_rates(), (0, S * per - len(
        spec.bg_rates()))).reshape(S, per).astype(np.float32)).cuda()
    drive = lif.poisson_input(bg.expand(N_WINDOWS, cfg.window, S, per),
                              87.8, cfg.params.dt, generator=gen)
    tb = tp.create("torus3d", n_shards=S, nx=2, ny=2, nz=2,
                   link_credits=limit, notify_latency=cfg.notify_latency)
    stats, rows = {}, []
    scheds = fault_schedules((2, 2, 2), N_WINDOWS, "cuda")
    for name, sched in {**scheds, None: None}.items():
        seg_init, run_segment, finish = sim.build_sharded_segments(
            cfg, part, spec.bg_rates(), fault_schedule=sched,
            device="cuda")

        def run(n_windows, drive=None):
            carry, st = run_segment(seg_init(0), n_windows, drive)
            _, miss = finish(carry)     # the drain's misses: last window
            m = st.deadline_miss.clone()
            m[:, -1] += miss
            return st._replace(deadline_miss=m)

        run(1, drive[:1])                       # warm-up
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t1 = time.perf_counter()
        st = run(N_WINDOWS, drive)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / N_WINDOWS
        launches = dict(dispatch.LAUNCHES)
        # the ring rotation's kernel in the healthy windows and in the
        # drain and the final flush; a masked window replays it
        want = {"flush_window": N_WINDOWS, "wire_codec": N_WINDOWS + 2,
                "lif_step": N_WINDOWS, "admission": N_WINDOWS,
                "torus_exchange": 2 + (N_WINDOWS if sched is None else 0)}
        if launches != want:
            raise AssertionError(f"fault matrix {name}: launches "
                                 f"{launches} != {want}")
        s = stats[name] = flatten(st)
        check_backpressure_chain(f"fault matrix {name}", s, S)
        if name is None:
            continue
        # window by window: the fabric state after each exchange
        carry, per_window = seg_init(0), []
        for k in range(N_WINDOWS):
            prev = carry.link
            carry, w_st = run_segment(carry, 1, drive[k:k + 1])
            per_window.append(flatten(w_st))
            link, dead = carry.link, faults.mask_at(sched, k)
            if not bool((link.bank.credits + link.bank.pending.sum(-1)
                         + link.parked_by_link == limit).all()):
                raise AssertionError(f"fault matrix {name} window {k}: "
                                     f"credits + pending + held != limit")
            spent = prev.bank.credits + prev.bank.pending[:, 0] \
                - link.bank.credits
            if int(spent[dead].abs().sum()) or int(
                    link.parked_by_link[dead].abs().sum()):
                raise AssertionError(f"fault matrix {name} window {k}: a "
                                     f"dead link spent or held credits")
        if not np.isfinite(carry.state.neuron.v.cpu().numpy()).all():
            raise AssertionError(f"fault matrix {name}: non-finite v")
        # the windows checked one by one are the timed run's windows
        _, miss = finish(carry)
        again = {key: np.concatenate([w[key] for w in per_window], axis=1)
                 for key in s}
        again["deadline_miss"][:, -1] += miss.cpu().numpy()
        for key in s:
            what = (f"fault matrix {name}: {key} of the window-by-window "
                    f"pass against the timed run")
            if s[key].dtype.kind == "f":      # as require_same_outputs
                np.testing.assert_allclose(again[key], s[key], rtol=1e-6,
                                           atol=1e-6, err_msg=what)
            elif not np.array_equal(again[key], s[key]):
                raise AssertionError(f"{what}: differs")
        fab = tb.drain_fabric(carry.link)
        if int(fab.state.parked_count.abs().sum()) or int(
                fab.state.parked_by_link.abs().sum()) or not bool((
                fab.state.bank.credits + fab.state.bank.pending.sum(-1)
                == limit).all()):
            raise AssertionError(f"fault matrix {name}: the drain left the "
                                 f"fabric's tables non-empty")
        if name in ("link_down", "link_flap") and \
                int(s["link.rerouted"].sum()) == 0:
            raise AssertionError(f"fault matrix {name}: no detour")
        rows.append(dict(
            fault=name, ms_per_window=ms,
            rerouted=int(s["link.rerouted"].sum()),
            parked=int(s["link.parked_events"].sum()),
            deferred=int(s["link.deferred_events"].sum()),
            deadline_miss=int(s["deadline_miss"].sum()),
            spikes=int(s["spikes"].sum()),
            delivered=int(s["link.delivered_events"].sum())))
        print(f"fault matrix {name}: {ms:.3f} ms per window ({N_WINDOWS} "
              f"windows + drain, host clock); rerouted "
              f"{rows[-1]['rerouted']}, parked {rows[-1]['parked']}, "
              f"deferred {rows[-1]['deferred']}, deadline misses "
              f"{rows[-1]['deadline_miss']}, spikes {rows[-1]['spikes']}, "
              f"delivered {rows[-1]['delivered']}; launches {launches}; "
              f"every window's checks passed")
        window_functions(lambda _state, n: run(n, drive[:n]), None, 3)
    # a stamped all-false mask changes nothing but hops (a masked ring
    # phase runs n - 1 hops each way, the reference's rule)
    a, b = stats["none"], stats[None]
    for key in a:
        if key != "link.hops" and not (a[key] == b[key]).all():
            raise AssertionError(f"healthy schedule: {key} differs from "
                                 f"the run without a schedule")
    print(f"healthy schedule == the run without one on every WindowStats "
          f"field but hops ({int(a['link.hops'][0, -1])} a window against "
          f"{int(b['link.hops'][0, -1])})")
    print("FAULT_MATRIX " + json.dumps(rows))


def check_fault_slice_small():
    """Card vs CPU for the window loop under chaos seed 0 on the credited
    torus3d 2x2x2 at scale 0.004 over 8 shards: every integer WindowStats
    field equal, floats within the LIF tolerances."""
    from repro_torch.convert import flatten
    from repro_torch.fabric import faults
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    spec = mc.MicrocircuitSpec(scale=0.004)
    part = network.build_partition(*spec.weight_matrix(),
                                   n_shards=TORUS_SHARDS)
    cfg = sim_config(part, e_max=256, capacity=16, residue=64,
                     transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
                     link_credits=16, notify_latency=2)
    n_win = 8
    rng = np.random.default_rng(0)
    drive = torch.from_numpy(rng.poisson(
        1.3, (n_win, cfg.window, TORUS_SHARDS, cfg.per_shard)).astype(
            np.float32) * np.float32(87.8))
    out = {}
    for device in ("cpu", "cuda"):
        sched = faults.chaos((2, 2, 2), n_win, 0, device=device)
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          fault_schedule=sched,
                                          device=device)
        st = init(0)
        if device == "cpu":
            v0 = st.neuron.v
        st = st._replace(neuron=st.neuron._replace(v=v0.to(device)),
                         generator=None)
        out[device] = run(st, n_win, drive=drive)
    require_same_outputs("fault slice card vs CPU", out["cuda"][1],
                         out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0].neuron.v.cpu(),
                               out["cpu"][0].neuron.v, rtol=2e-5, atol=1e-4)
    s = flatten(out["cpu"][1])
    check_backpressure_chain("fault slice", s, TORUS_SHARDS)
    rerouted = int(s["link.rerouted"].sum())
    if rerouted == 0:
        raise AssertionError("fault slice: no detour")
    print(f"fault slice (scale 0.004, torus3d 2x2x2, credits 16, chaos "
          f"seed 0, {n_win} windows): card == CPU on every integer stat; "
          f"{rerouted} events rerouted, {int(s['link.parked_events'].sum())}"
          f" parked, {int(s['spikes'].sum())} spikes")


# ---------------------------------------------------------------------------
# Main path 4: the multi-tenant spike serving engine, and kernel F's tenant
# form.
# ---------------------------------------------------------------------------

# benchmarks/bench_serve.py:140-155, the full (non-smoke) deployment behind
# BENCH_serve.json
SERVE_CFG = dict(capacity=32, link_credits=64, notify_latency=2,
                 window_us=100.0, seg_windows=8, nx=2, ny=2, nz=2,
                 queue_depth=2)
SERVE_TENANTS = (("quiet", 32, 40.0), ("hot", 8, 600.0))
SERVE_SHARDS, SERVE_SEGMENTS, SERVE_SEED = 8, 24, 7
SERVE_SMALL_SEGMENTS = 3
QOS_P99_BOUND = 4.0                # benchmarks/bench_serve.py:35
SERVE_FAULT_START = 2              # link_fault(0, x+) from window 2
# every how many windows of each main-path-4 run phase 5i checks the
# admission state against the plain replay (eager on the card): 32-36
# windows a run, spread over it and its drain
SERVE_CAPTURE_EVERY = 6


def serve_engine(device, hot: bool, fault: bool = False, recorder=None,
                 tracer=None):
    """The bench_serve deployment on ``device``: 8 shards on torus3d
    2x2x2, the quiet tenant (reserve 32, 40 events a window) and the hot
    one (reserve 8, 600 events a window, bursts x3 at p 0.25; rate 0 when
    ``hot`` is False), seed 7; ``fault``: the cable x+ of node 0 dead from
    window 2; ``recorder`` / ``tracer`` as the engine takes them."""
    from repro_torch.fabric import faults
    from repro_torch.serve import loadgen, spike_engine, tenancy
    specs = [tenancy.TenantSpec(n, reserve=r, rate_epw=rate)
             for n, r, rate in SERVE_TENANTS]
    profiles = [loadgen.TenantProfile("quiet", SERVE_TENANTS[0][2]),
                loadgen.TenantProfile("hot", SERVE_TENANTS[1][2] if hot
                                      else 0.0, burst_factor=3.0,
                                      burst_prob=0.25)]
    cfg = spike_engine.EngineConfig(**SERVE_CFG)
    src = loadgen.PoissonLoadGen(SERVE_SEED, profiles, SERVE_SHARDS,
                                 cfg.capacity)
    n_win = SERVE_SEGMENTS * cfg.seg_windows
    sched = (faults.link_fault((2, 2, 2), n_win, 0, 0,
                               start=SERVE_FAULT_START, device=device)
             if fault else None)
    return spike_engine.SpikeEngine(SERVE_SHARDS, specs, cfg, src,
                                    fault_schedule=sched, recorder=recorder,
                                    tracer=tracer, device=device)


def _report_ints(rep) -> dict:
    out = {f: np.asarray(getattr(rep, f)) for f in (
        "injected", "delivered", "shed", "clipped")}
    out["windows"] = np.array([rep.windows, rep.drain_windows,
                               int(rep.conservation_checked)])
    for d in rep.tenants:
        out[d.name + ".hist"] = d.hist
        out[d.name + ".p50_p99_delivered"] = np.array(
            [d.p50_us, d.p99_us, d.delivered])
    return out


def check_serve_slice_small():
    """The engine at the deployment's shapes for 3 segments of 8 windows,
    solo and contended, on the card against the same run on the CPU (the
    plain versions): every EngineReport integer, every per-window
    WindowServeStats integer and every latency histogram equal; max and
    mean at rtol 1e-6."""
    from repro_torch.convert import flatten
    for hot in (False, True):
        runs = {}
        for device in ("cuda", "cpu"):
            eng = serve_engine(device, hot)
            rep = eng.run(SERVE_SMALL_SEGMENTS)
            runs[device] = (rep, eng.window_stats)
        (rc, wc), (rp, wp) = runs["cuda"], runs["cpu"]
        label = "contended" if hot else "solo"
        for key, a in _report_ints(rc).items():
            if not np.array_equal(a, _report_ints(rp)[key]):
                raise AssertionError(f"serve slice {label}: {key} card "
                                     f"{a} != CPU {_report_ints(rp)[key]}")
        for x, y in zip(rc.tenants, rp.tenants):
            np.testing.assert_allclose([x.max_us, x.mean_us],
                                       [y.max_us, y.mean_us], rtol=1e-6)
        if len(wc) != len(wp):
            raise AssertionError(f"serve slice {label}: {len(wc)} segments "
                                 f"on the card, {len(wp)} on the CPU")
        for k, (a, b) in enumerate(zip(wc, wp)):
            fa, fb = flatten(a), flatten(b)
            for key in fa:
                if fa[key].dtype.kind == "f":
                    np.testing.assert_allclose(fa[key], fb[key], rtol=1e-6,
                                               atol=1e-6,
                                               err_msg=f"{label} {key}")
                elif not np.array_equal(fa[key], fb[key]):
                    raise AssertionError(f"serve slice {label} segment "
                                         f"{k}: {key} differs card vs CPU")
        print(f"serve slice {label} ({SERVE_SMALL_SEGMENTS} segments of "
              f"{SERVE_CFG['seg_windows']} windows + {rc.drain_windows} "
              f"drain): card == CPU on every report integer, {len(wc)} "
              f"segments of WindowServeStats and the histograms; injected "
              f"{rc.injected.tolist()}, delivered {rc.delivered.tolist()}, "
              f"shed {rc.shed.tolist()}")


def _serve_eager_windows(hot: bool, n_segments: int) -> None:
    """The deployment's first ``n_segments`` served segments from a fresh
    engine's carry, window by window with the index on the host (eager:
    the wrappers are called, as no replay of the engine's graph calls
    them)."""
    eng = serve_engine("cuda", hot)
    nw, carry = eng.cfg.seg_windows, eng._carry
    with eng._on_stream():
        for k in range(n_segments):
            eng._fill_segment(0, k)
            fw, fc_, copied = eng._stage(0)
            copied.synchronize()
            carry, _ = eng._segment_windows(carry, fw, fc_, k * nw)
    torch.cuda.synchronize()


def _serve_segment_profile(eng, seg: int):
    """torch.profiler over served segment ``seg`` (its traffic staged and
    run from the engine's initial carry after ``seg`` segments)."""
    nw = eng.cfg.seg_windows
    with eng._on_stream():
        carry = eng._carry
        for k in range(seg + 1):
            eng._fill_segment(0, k)
            fw, fc_, copied = eng._stage(0)
            copied.synchronize()
            if k < seg:
                carry, ws = eng._segment(carry, fw, fc_, k * nw)
                eng._ready(ws)
        torch.cuda.synchronize()
        return profile_device(
            lambda: eng._ready(eng._segment(carry, fw, fc_, seg * nw)[1]),
            f"one served segment ({nw} windows, contended)", nw, "window")


CLOCK_SHARE_MIN = 0.99          # runtime calls inside the thread's spans
CLOCK_PASSES = 3                # profiler passes before the check fails
CLOCK_SUMMARY = ROOT / "build" / "serve_clock.json"
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync")


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _count_inside(union: list, events) -> int:
    """How many of the complete ``events`` lie inside one interval of
    ``union`` (sorted, disjoint)."""
    import bisect
    starts = [u[0] for u in union]
    n = 0
    for e in events:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        n += i >= 0 and e["ts"] + e["dur"] <= union[i][1]
    return n


def _loop_stages(spans: list, track_of) -> dict:
    """The device loop over ``spans`` (the tracer's complete events on its
    own clock): host ms per served window of each stage and of the whole
    dispatch, the dispatch's share off the CPU (its ``cpu_us`` against
    its wall time), and the share of the device thread's loop (from its
    first loop span to its last) spent waiting for the stats copy."""
    dev = [e for e in spans if track_of(e) == "spike-device"
           and e["name"] in ("device/staged_wait", "device/h2d",
                             "device/dispatch", "device/stats_wait")]
    seg = [e for e in dev if e["name"] == "device/dispatch"]
    if not seg:
        return {}
    wins = len(seg) * SERVE_CFG["seg_windows"]
    out = {"segments": len(seg),
           "dispatch_ms_per_window": sum(e["dur"] for e in seg) / wins / 1e3}
    for stage in ("window/exchange", "window/attribute"):
        inside = [e["dur"] for e in spans if e["name"] == stage
                  and any(d["ts"] <= e["ts"] and e["ts"] + e["dur"]
                          <= d["ts"] + d["dur"] for d in seg)]
        out[stage.split("/")[1] + "_ms_per_window"] = sum(inside) / wins / 1e3
    wall = sum(e["dur"] for e in seg)
    out["dispatch_offcpu_pct"] = 100.0 * (
        1.0 - sum(e["args"]["cpu_us"] for e in seg) / wall)
    extent = max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)
    out["stats_wait_pct"] = 100.0 * sum(
        e["dur"] for e in dev if e["name"] == "device/stats_wait") / extent
    return out


def serve_clock(hot: bool, seconds: float = 0.5, after_s: float = 2.0
                ) -> dict:
    """The deployment (``hot``: contended) served by the engine's own
    threads with a tracer, torch.profiler over ``seconds`` of it, the
    spans put on the profiler's clock -> the device thread's runtime calls
    inside its spans, the share of them whose kernel or copy the profiler
    recorded, the device's idle gaps named by the innermost span of that
    thread running at their midpoint; then ``after_s`` more of serving
    without the profiler, read by :func:`_loop_stages`."""
    import collections
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import spans
    tracer = spans.Tracer()
    eng = serve_engine("cuda", hot, tracer=tracer)
    eng.warmup()
    torch.cuda.synchronize()
    eng.start()
    device_os = eng._device_t.native_id
    time.sleep(0.5)                       # past the first segments
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(seconds)
    profiled_to = tracer.now_us()
    time.sleep(after_s)
    eng.stop(drain=True)
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/prof.json")
        theirs = json.loads(Path(f"{tmp}/prof.json").read_text())
    mine = tracer.to_dict()
    names = spans.thread_names(mine)
    after = _loop_stages([e for e in mine["traceEvents"] if e["ph"] == "X"
                          and e["ts"] >= profiled_to],
                         lambda e: names[e["tid"]])
    merged = spans.on_profiler_clock(mine, theirs)
    ours = [e for e in merged["traceEvents"] if e.get("ph") == "X"
            and e.get("args", {}).get("os_tid") == device_os]
    union = _union((e["ts"], e["ts"] + e["dur"]) for e in ours)
    ids = {k: ours[0]["args"][k] for k in ("os_tid", "pthread_tid")}
    runtime = [e for e in theirs["traceEvents"] if e.get("ph") == "X"
               and e.get("name") in RUNTIME_CALLS]
    by_tid = collections.Counter(e.get("tid") for e in runtime)
    matched = [k for k, v in ids.items() if v in by_tid]
    tid = ids[matched[0]] if matched else None
    calls = [e for e in runtime if e.get("tid") == tid]
    inside = _count_inside(union, calls)
    device_ops = [e for e in theirs["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    recorded = {e["args"].get("correlation") for e in device_ops}
    with_op = sum(e["args"].get("correlation") in recorded for e in calls)
    busy = _union((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in device_ops)
    gaps: dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        held = [e for e in ours if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = (min(held, key=lambda e: e["dur"])["name"] if held
                else "no program span")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    stretch = (busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0
    return dict(
        device_thread_ids=ids, profiler_tid=tid, matched_as=matched,
        shift_us=(mine["otherData"]["epoch_origin_ns"]
                  - theirs.get("baseTimeNanoseconds", 0)) / 1e3,
        runtime_calls=len(calls), inside_spans=int(inside),
        share_inside=inside / len(calls) if calls else None,
        with_device_op=int(with_op),
        share_with_device_op=with_op / len(calls) if calls else None,
        program_spans_on_thread=len(ours),
        device_stretch_s=stretch,
        device_busy_s=sum(b - a for a, b in busy) * 1e-6,
        idle_gaps_s=dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        after_profile=after)


def check_serve_clock(smi: str) -> dict:
    """:func:`serve_clock` contended and solo: at least
    ``CLOCK_SHARE_MIN`` of the device thread's runtime calls inside its
    spans, with no fitted offset, and as large a share of them with their
    kernel or copy in the profiler's trace.  A pass whose trace lost the
    card's events (the profiler dropped nearly all of them in 3 of 15
    passes on an H100) names its idle gaps by a few long ones between the
    events it kept: it is counted and run again, ``CLOCK_PASSES`` times at
    most.  Writes the summaries to ``CLOCK_SUMMARY``."""
    out = {"device": smi, "torch": torch.__version__}
    for label, hot in (("contended", True), ("solo", False)):
        for lost in range(CLOCK_PASSES):
            got = serve_clock(hot)
            if (got["share_with_device_op"] or 0.0) >= CLOCK_SHARE_MIN:
                break
            print(f"[{smi}] serve clock, {label}: the profiler kept the "
                  f"kernel or copy of {got['with_device_op']} of "
                  f"{got['runtime_calls']} calls; again")
        else:
            lost = CLOCK_PASSES
        got = out[label] = dict(got, passes_with_events_lost=lost)
        print(f"[{smi}] program spans on the profiler's clock, {label}: "
              f"{got['inside_spans']} of the device thread's "
              f"{got['runtime_calls']} {' / '.join(RUNTIME_CALLS)} calls "
              f"inside its spans (thread as {got['matched_as']}; shift "
              f"{got['shift_us']:.3f} us from the anchors), "
              f"{got['with_device_op']} with their kernel or copy "
              f"recorded; device busy {got['device_busy_s']:.6f} of "
              f"{got['device_stretch_s']:.6f} s; idle gaps by innermost "
              f"span: " + ", ".join(f"{k} {v:.6f} s" for k, v in
                                    got["idle_gaps_s"].items())
              + f"; unprofiled after it: {got['after_profile']}")
        if (not got["runtime_calls"]
                or got["share_inside"] < CLOCK_SHARE_MIN
                or got["share_with_device_op"] < CLOCK_SHARE_MIN):
            raise AssertionError(f"serve clock, {label}: {got}")
    CLOCK_SUMMARY.parent.mkdir(exist_ok=True)
    CLOCK_SUMMARY.write_text(json.dumps(out, indent=1) + "\n")
    return out


def run_serve_main_path(smi: str):
    """Main path 4: the bench_serve deployment for 24 segments (192
    windows), solo, contended and contended under link_fault(0, x+) from
    window 2, each after warmup(): conservation per tenant, the QoS factor,
    launches per served window, a profile of one segment, events/s and ms
    per window (host clock), peak device memory."""
    from repro_torch.kernels import dispatch
    bench = {r["op"]: r for r in json.loads(
        (ROOT / "BENCH_serve.json").read_text())}
    reports, launches, captured = {}, {}, []
    for label, hot, fault in (("solo", False, False),
                              ("contended", True, False),
                              ("contended, link_fault(0, x+)", True, True)):
        eng = serve_engine("cuda", hot, fault)
        eng.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()      # earlier phases' tensors
        dispatch.reset_launches()
        calls, rep = capture_admission(
            lambda: eng.run(SERVE_SEGMENTS, timeout=900),
            ("admission_tenants", "admission_tenants_blocks"),
            SERVE_CAPTURE_EVERY)
        launches[label] = dict(dispatch.LAUNCHES)
        entries = dict(dispatch.ENTRY_LAUNCHES)
        if not fault:
            # the healthy run replays a CUDA graph, which calls no wrapper:
            # the same windows again, eagerly, for F's inputs
            calls, _ = capture_admission(
                lambda: _serve_eager_windows(hot, SERVE_SEGMENTS),
                ("admission_tenants", "admission_tenants_blocks"),
                SERVE_CAPTURE_EVERY)
        captured += [(label, *c) for c in calls]
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        reports[label] = rep
        if not rep.conservation_checked or not np.array_equal(
                rep.injected, rep.delivered + rep.shed):
            raise AssertionError(f"{label}: conservation not checked or "
                                 f"violated: {rep}")
        if rep.windows != SERVE_SEGMENTS * SERVE_CFG["seg_windows"]:
            raise AssertionError(f"{label}: served {rep.windows} windows")
        # one replay, one encode and one decode a window (drain segments
        # included); the final walk encodes once and decodes twice
        n_win = rep.windows + rep.drain_windows
        # kernel H after F in every healthy credited window, none under
        # the dead cable's mask; the final walk's two rotations
        want = {"repro_admission_tenants": n_win, "repro_torus_rotate": 2,
                "repro_wire_encode": n_win + 1,
                "repro_wire_decode": n_win + 2}
        if not fault:
            want["repro_tenant_exchange"] = n_win
        if entries != want:
            raise AssertionError(f"{label}: launches by entry point "
                                 f"{entries} != {want}")
        print(f"{label}: {rep.windows} windows + {rep.drain_windows} drain "
              f"windows; launches per window: admission "
              f"{entries['repro_admission_tenants'] / n_win:.0f}, exchange "
              f"epilogue (kernel H) "
              f"{entries.get('repro_tenant_exchange', 0) / n_win:.0f}, "
              f"encode {(entries['repro_wire_encode'] - 1) / n_win:.0f}, "
              f"decode {(entries['repro_wire_decode'] - 2) / n_win:.0f} (+ "
              f"the walk's 1 encode, 2 decodes, 2 rotations); "
              f"{launches[label]}")
        print(f"{label} [{smi}]: {rep.events_per_s:.0f} events/s, "
              f"{rep.wall_s * 1e3 / rep.windows:.3f} ms per served window "
              f"(host clock, ingest start to last absorb), peak device "
              f"memory {peak:.1f} MiB above the {held / 2**20:.1f} MiB "
              f"held before the run")
        for t, d in enumerate(rep.tenants):
            b = bench.get(f"tenant/{d.name}", {})
            print(f"  {d.name}: injected {rep.injected[t]}, delivered "
                  f"{rep.delivered[t]}, shed {rep.shed[t]}, clipped "
                  f"{rep.clipped[t]}; p50 {d.p50_us} us, p99 {d.p99_us} us, "
                  f"max {d.max_us:.3f} us, mean {d.mean_us:.3f} us"
                  + (f"  [BENCH_serve.json (jax 0.4.37): {b['injected']} / "
                     f"{b['delivered']} / {b['shed']} / {b['clipped']}, p50 "
                     f"{b['latency_p50_us']}, p99 {b['latency_p99_us']}]"
                     if b and label == "contended" else ""))
    solo, cont = reports["solo"], reports["contended"]
    if not np.array_equal(solo.injected[0], cont.injected[0]):
        raise AssertionError("the quiet tenant's traffic differs solo vs "
                             "contended")
    factor = cont.tenants[0].p99_us / max(solo.tenants[0].p99_us, 1e-9)
    q = bench.get("qos/quiet_p99", {})
    print(f"QoS: quiet p99 contended {cont.tenants[0].p99_us} us / solo "
          f"{solo.tenants[0].p99_us} us = factor {factor:.3f} (bound "
          f"{QOS_P99_BOUND}; BENCH_serve.json: {q.get('factor')})")
    if factor > QOS_P99_BOUND:
        raise AssertionError(f"QoS violated: factor {factor:.3f} > "
                             f"{QOS_P99_BOUND}")
    if int(reports["contended, link_fault(0, x+)"].shed[1]) == 0:
        raise AssertionError("faulted run: the hot tenant shed nothing")
    eng = serve_engine("cuda", True)
    eng.warmup()
    print(f"[{smi}]")
    _serve_segment_profile(eng, 4)
    check_serve_clock(smi)
    total = {k: sum(v.get(k, 0) for v in launches.values())
             for k in ("admission", "wire_codec")}
    return total, captured, reports


def n_links(counts, tables) -> int:
    """K, the physical links of an (T, S, S) tenant replay's torus."""
    return counts.shape[-1] * 2 * tables.seg.shape[0]


def check_admission_tenants(captured, smi: str):
    """Kernel F's tenant form against the plain replay, bit for bit on
    every TenantAdmissionOut field, on the states main path 4 captured
    (solo, contended and faulted runs): without a mask against the healthy
    replay, and with an all-false mask against the healthy and the masked
    replay; with a mask against the masked replay.  Then F's time per call
    (CUDA graph) at the last contended state against its chain bound, and
    the replay's times."""
    from repro_torch.kernels import admission as adm
    seen = dict(hold_shared=0, parked=0, deferred=0, rerouted=0, masked=0,
                stalled=0)
    for label, w, counts, state, tables, down in captured:
        what = f"{label} window {w}"
        got = adm.admission_tenants(counts, state, tables, down,
                                    stall_lane=True)
        check_stall_lane(what, got, counts)
        if down is None:
            plain = adm.admission_tenants_plain(counts, state, tables,
                                                stall_lane=True)
            require_equal(f"{what}: tenant F vs the healthy replay",
                          list(zip(got, plain)))
            off = torch.zeros(n_links(counts, tables), dtype=torch.bool,
                              device=counts.device)
            masked = adm.admission_tenants(counts, state, tables, off,
                                           stall_lane=True)
            for name, want in (("healthy", plain), (
                    "masked", adm.admission_tenants_plain(
                        counts, state, tables, off, stall_lane=True))):
                require_equal(f"{what}: tenant F, all-false mask, vs the "
                              f"{name} replay", list(zip(masked, want)))
        else:
            require_equal(f"{what}: tenant F vs the masked replay", list(zip(
                got, adm.admission_tenants_plain(
                    counts, state, tables, down, stall_lane=True))))
            seen["masked"] += 1
        seen["hold_shared"] += int((got.hold_shared > 0).sum())
        seen["parked"] += int(got.fresh_park.sum())
        seen["deferred"] += int((got.stall_hop >= 0).sum())
        seen["rerouted"] += int(got.rerouted.sum())
        seen["stalled"] += int(got.stalled_by_link.sum())
    if not all(seen.values()):
        raise AssertionError(f"tenant admission cases exercised too "
                             f"little: {seen}")
    # the last captured served (not drain) window of the contended run
    served = SERVE_SEGMENTS * SERVE_CFG["seg_windows"]
    label, w, counts, state, tables, _ = [
        c for c in captured if c[0] == "contended" and c[1] < served][-1]
    T, n = counts.shape[0], counts.shape[1]
    ms, eager_ms = time_ms(lambda: adm.admission_tenants(counts, state,
                                                         tables))
    lane_ms, lane_eager_ms = time_ms(lambda: adm.admission_tenants(
        counts, state, tables, stall_lane=True))
    healthy_ms = time_loop(lambda: adm.admission_tenants_plain(
        counts, state, tables))
    off = torch.zeros(n_links(counts, tables), dtype=torch.bool,
                      device=counts.device)
    faulted_ms = time_loop(lambda: adm.admission_tenants_plain(
        counts, state, tables, off))
    out = adm.admission_tenants(counts, state, tables)
    n_bytes = (sum(x.numel() * x.element_size() for x in (
        counts, state.parked_count, state.parked_hop, state.parked_age,
        state.parked_hold_shared, state.bank.credits, state.bank.epoch,
        state.parked_by_link, tables.seq_alt[0], tables.len_alt[0]))
        + sum(x.numel() * x.element_size() for x in out[:-1]))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    eye = torch.eye(n, dtype=torch.bool, device=counts.device)
    steps = int((state.parked_count > 0).sum()) + int(
        ((counts > 0) & ~eye).sum())
    t_chain = steps * SHARED_ROUND_TRIP_CYCLES / SM_CLOCK_HZ * 1e3
    bms, by = max((t_bytes, "bytes"), (t_chain, "operations"))
    print(f"[{smi}] admission (tenant form): {len(captured)} windows bit "
          f"for bit against the plain replay ({seen}); at main path 4's "
          f"contended window {w} ({T} tenants, {n} shards, "
          f"{state.bank.credits.shape[0]} slots): kernel {ms:.4f} ms (CUDA graph), "
          f"eager {eager_ms:.4f} ms; the plain replay {healthy_ms:.3f} ms "
          f"healthy and {faulted_ms:.3f} ms under an all-false mask a call "
          f"(eager, events around 5 calls); bound {bms:.6f} ms ({steps} dependent steps of "
          f"{2 * T * n * n} rows x {SHARED_ROUND_TRIP_CYCLES} cycles at "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz = {t_chain:.6f} ms; {n_bytes} B = "
          f"{t_bytes:.6f} ms); with the stall lane: kernel {lane_ms:.4f} ms "
          f"(CUDA graph), eager {lane_eager_ms:.4f} ms, in the same call")
    return dict(tenant_ms=ms, tenant_lane_ms=lane_ms, tenant_bound_ms=bms,
                tenant_bound_by=by,
                tenant_healthy_loop_ms=healthy_ms,
                tenant_faulted_loop_ms=faulted_ms, tenant_steps=steps)


def _same_fields(what: str, got, want) -> int:
    """Every leaf of two trees of NamedTuples: same fields, dtypes and
    shapes, integers and booleans equal, floats equal bit for bit ->
    the number of leaves."""
    from repro_torch.convert import flatten
    a, b = flatten(got), flatten(want)
    if set(a) != set(b):
        raise AssertionError(f"{what}: fields {sorted(set(a) ^ set(b))}")
    for key in a:
        x, y = a[key], b[key]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: {key} {x.dtype} {x.shape} vs "
                                 f"{y.dtype} {y.shape}")
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: {key} differs from the eager "
                                 f"chain")
    return len(a)


def check_torus_exchange(smi: str) -> dict:
    """Kernel H (the tenant exchange epilogue) and the shared ring rotation
    against the eager chain on the card (the same kernel F before both;
    the rotation replayed): every TransportOut, LinkStats and FabricState
    field, integers bit for bit and floats exact, on a recorded contended
    segment of main path 4's deployment (8 windows' states, payloads and
    counts, captured at the transport), one launch of H a window; the
    rotation at the serving (E = T) and microcircuit (E = 1) shapes; then
    times per call: H and the rotation (CUDA graph, and eager from Python),
    the window's exchange (F + H) against the eager chain."""
    import copy
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import dispatch, torus_exchange as tx
    from repro_torch.transport import torus as tt
    eng = serve_engine("cuda", True)
    eng.warmup()
    tr = eng.transport
    real, calls = tr.exchange, []
    clone = lambda t: None if t is None else t.clone()

    def spy(state, payload, counts, **kw):
        if not kw:                               # credited windows
            calls.append((type(state)(*(
                type(x)(*map(clone, x)) if hasattr(x, "_fields")
                else clone(x) for x in state)), payload.clone(),
                counts.clone()))
        return real(state, payload, counts, **kw)

    tr.exchange = spy
    try:
        eng.run(3, timeout=600)
    finally:
        del tr.exchange
    torch.cuda.synchronize()
    seg = SERVE_CFG["seg_windows"]
    recorded = calls[seg:2 * seg]                # the second segment
    plain = copy.copy(tr)
    plain._rotate = plain._rotate_plain
    leaves = parked = resumed = deferred = 0      # leaves: of one window
    for i, (state, payload, counts) in enumerate(recorded):
        dispatch.reset_launches()
        got = tr.exchange(state, payload, counts)
        if dispatch.ENTRY_LAUNCHES != {"repro_admission_tenants": 1,
                                       "repro_tenant_exchange": 1}:
            raise AssertionError(f"window {i}: launches "
                                 f"{dispatch.ENTRY_LAUNCHES}, want F and H "
                                 f"once each")
        want = tt.TorusTransport.exchange(plain, state, payload, counts)
        leaves = _same_fields(f"kernel H, contended window {i}", got, want)
        cin = want.recv_counts.permute(2, 0, 1)
        _same_fields(f"rotation, window {i}", tr._rotate(cin),
                     tr._rotate_plain(cin))
        parked += int(want.stats.parked_events.sum())
        resumed += int(want.stats.unparked_events.sum())
        deferred += int(want.stats.deferred_events.sum())
    if not (parked and deferred):
        raise AssertionError(f"the recorded segment parked {parked} and "
                             f"deferred {deferred} events")
    mc = tt.Torus3DTransport(8, nx=2, ny=2, nz=2, link_credits=124,
                             notify_latency=4, max_row_events=124)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for hi in (20, 125, 400):
        cnt = torch.randint(0, hi, (8, 8), generator=gen, device="cuda",
                            dtype=torch.int32)
        _same_fields(f"rotation E = 1, counts < {hi}", mc._rotate(cnt),
                     mc._rotate_plain(cnt))
    # times at the recorded segment's last window
    state, payload, counts = recorded[-1]
    blocks = adm.admission_tenants_blocks(
        counts.transpose(0, 1).contiguous(), state,
        tr._dev(counts.device)["routes"])
    h_call = lambda: tx.tenant_exchange(
        counts, payload, state, blocks, dims=tr.dims, fmt=tr.wire_fmt,
        link_credits=tr.link_credits, max_hops=tr.max_hops)
    ms, eager_ms = time_ms(h_call)
    cin = recorded[-1][2].permute(0, 2, 1)
    rot_ms, rot_eager_ms = time_ms(lambda: tr._rotate(cin))
    _, win_eager_ms = time_ms(lambda: tr.exchange(state, payload, counts))
    chain = lambda: tt.TorusTransport.exchange(plain, state, payload, counts)
    chain_eager_ms = time_loop(chain, calls=10)
    # the chain copies host scalars, so no CUDA graph: its device time is
    # the profiler's sum over its kernels and copies, less F's
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            chain()
        torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()}
    f_us = sum(v for k, v in dev_us.items() if "admission" in k)
    chain_ms = (sum(dev_us.values()) - f_us) / 10 / 1e3
    out = h_call()
    # what it reads once and its one output allocation
    n_bytes = (sum(x.numel() * x.element_size() for x in (
        counts, payload, state.parked_count, state.parked_payload,
        state.bank.credits, state.bank.pending, *blocks[:3]))
        + out.recv_payload.untyped_storage().nbytes())
    bms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[{smi}] kernel H (tenant exchange epilogue): {len(recorded)} "
          f"contended windows, {leaves} fields each window bit for bit "
          f"against the eager chain (parked {parked}, unparked {resumed}, "
          f"deferred {deferred}); the rotation at E = T and E = 1 likewise; "
          f"H {ms * 1e3:.2f} us a call (CUDA graph), eager "
          f"{eager_ms * 1e3:.1f} us; the rotation alone {rot_ms * 1e3:.2f} "
          f"us (graph), eager {rot_eager_ms * 1e3:.1f} us; bound "
          f"{bms * 1e3:.4f} us ({n_bytes} B); the window's exchange F + H "
          f"eager {win_eager_ms:.4f} ms, the eager chain (F + its ATen "
          f"calls) {chain_eager_ms:.4f} ms eager, its ATen calls "
          f"{chain_ms * 1e3:.2f} us of device time (profiler, F left out)")
    return dict(name="torus_exchange", route="cuda",
                source="src/repro_torch/csrc/torus_exchange.cu",
                replaces="none: no TPU kernel (the reference's ring phases "
                         "and LinkStats chain, src/repro/transport/torus.py)",
                max_abs_err=0.0, ms=ms, plain_ms=chain_ms, bound_ms=bms,
                bound_by="bytes", library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=chain_eager_ms, rotate_ms=rot_ms,
                rotate_eager_ms=rot_eager_ms, window_eager_ms=win_eager_ms,
                parity=f"bit-exact ({len(recorded)} contended windows, "
                       f"every field; the rotation at E = T and E = 1)")


# ---------------------------------------------------------------------------
# Observability: the recorded simulator (obs-sim) and the instrumented
# spike engine (obs-serve).
# ---------------------------------------------------------------------------

OBS_SIM_DEPTH, OBS_SERVE_DEPTH = 32, 256
OBS_DIR = ROOT / "build" / "obs"           # the run directories written


def check_obs_slice_small():
    """Card vs CPU with observability on: the small torus run of
    ``check_torus_slice_small`` under a dead cable from window 2 with the
    flight recorder (global and per-shard ring rows equal, stall tables
    included), and 3 segments of the serve slice's contended engine with
    the recorder and a tracer (ring rows equal, both traces valid)."""
    from repro_torch import obs
    from repro_torch.fabric import faults
    from repro_torch.obs import spans
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    spec = mc.MicrocircuitSpec(scale=0.004)
    part = network.build_partition(*spec.weight_matrix(),
                                   n_shards=TORUS_SHARDS)
    cfg = sim_config(part, e_max=256, capacity=16, residue=64,
                     transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
                     link_credits=16, notify_latency=2)
    n_win = 8
    rng = np.random.default_rng(0)
    drive = torch.from_numpy(rng.poisson(
        1.3, (n_win, cfg.window, TORUS_SHARDS, cfg.per_shard)).astype(
            np.float32) * np.float32(87.8))
    out, stats = {}, {}
    for device in ("cpu", "cuda"):
        sched = faults.link_fault((2, 2, 2), n_win, 0, 0, start=2,
                                  device=device)
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          fault_schedule=sched,
                                          recorder=obs.RecorderConfig(16),
                                          device=device)
        st = init(0)
        if device == "cpu":
            v0 = st.neuron.v
        st = st._replace(neuron=st.neuron._replace(v=v0.to(device)),
                         generator=None)
        _, stats[device], ring = run(st, n_win, drive=drive)
        out[device] = [obs.global_rows(ring, TORUS_SHARDS)] + [
            obs.ring_rows(obs.ring_shard(ring, s))
            for s in range(TORUS_SHARDS)]
    require_same_outputs("obs slice card vs CPU", stats["cuda"],
                         stats["cpu"])
    if out["cuda"] != out["cpu"]:
        raise AssertionError("obs slice: the ring's rows differ card vs CPU")
    rows = out["cpu"][0]
    stalled = sum(sum(r["stalled_by_link"]) for r in rows)
    if stalled == 0 or sum(r["counters"]["rerouted"] for r in rows) == 0:
        raise AssertionError("obs slice: no stall or no detour recorded")
    engines = {}
    for device in ("cpu", "cuda"):
        tracer = spans.Tracer()
        eng = serve_engine(device, True, recorder=obs.RecorderConfig(64),
                           tracer=tracer)
        eng.run(SERVE_SMALL_SEGMENTS)
        if spans.validate_trace(tracer.to_dict()):
            raise AssertionError(f"obs slice: {device} trace invalid")
        engines[device] = [eng.recorder_rows()] + [
            eng.recorder_rows(s) for s in range(SERVE_SHARDS)]
    if engines["cuda"] != engines["cpu"]:
        raise AssertionError("obs slice: the engine's ring rows differ card "
                             "vs CPU")
    print(f"obs slice: card == CPU on the recorded torus run ({n_win} "
          f"windows, a dead cable from window 2; {stalled} stalled events "
          f"in the stall tables) and the instrumented engine "
          f"({SERVE_SMALL_SEGMENTS} segments, {len(engines['cpu'][0])} "
          f"windows recorded): global and per-shard ring rows equal, "
          f"traces valid")


def run_obs_sim(part, spec, smi: str):
    """obs-sim: main path 3's network (scale 0.2, 8 shards, torus3d 2x2x2,
    binding credits 124, notify latency 4) for 25 windows with the flight
    recorder (depth 32), healthy and under link_fault(0, x+) from window 2,
    each beside the same run without it: the launches (F, A, C once a
    window), the observer effect (every integer WindowStats field and v
    equal), the ring against LinkStats per window and shard, the stall
    table against the global deferrals, device functions per window off
    and on, and a run directory whose report names the congested links
    and the cable's death at window 2.  -> launches of the recorded
    runs."""
    from repro_torch import obs
    from repro_torch.convert import flatten
    from repro_torch.fabric import faults
    from repro_torch.kernels import dispatch
    from repro_torch.obs import metrics, report
    from repro_torch.snn import simulator as sim
    cfg = sim_config(part, **{**dict(e_max=1024, capacity=1024, residue=256),
                              **TORUS_RUNS["torus3d, binding credits"]})
    dims, S = (2, 2, 2), TORUS_SHARDS
    total: dict = {}
    for label, fault in (("healthy", False), ("link_fault(0, x+)", True)):
        sched = (faults.link_fault(dims, N_WINDOWS, 0, 0, start=2,
                                   device="cuda") if fault else None)
        # the ring rotation's kernel in the healthy windows, the drain and
        # the final flush
        want = {"flush_window": N_WINDOWS, "lif_step": N_WINDOWS,
                "admission": N_WINDOWS, "wire_codec": N_WINDOWS + 2,
                "torus_exchange": 2 + (0 if fault else N_WINDOWS)}
        runs, walls = {}, {False: [], True: []}
        # off, on, on, off: the host clock drifts within a call
        for on in (False, True, True, False):
            init, run = sim.build_sharded_sim(
                cfg, part, spec.bg_rates(), fault_schedule=sched,
                recorder=obs.RecorderConfig(depth=OBS_SIM_DEPTH) if on
                else None, device="cuda")
            state = init(seed=0)
            torch.cuda.synchronize()
            dispatch.reset_launches()
            t1 = time.perf_counter()
            res = run(state, N_WINDOWS)
            torch.cuda.synchronize()
            walls[on].append((time.perf_counter() - t1) * 1e3 / N_WINDOWS)
            launches = dict(dispatch.LAUNCHES)
            if launches != want:
                raise AssertionError(f"obs-sim {label}, recorder {on}: "
                                     f"launches {launches} != {want}")
            runs.setdefault(on, (res, run, state))
        for k, v in launches.items():       # the last on-run's launches
            total[k] = total.get(k, 0) + v
        (st_off, stats_off), run_off, state0 = runs[False]
        (st_on, stats_on, ring), run_on, _ = runs[True]
        a, b = flatten(stats_off), flatten(stats_on)
        if set(b) - set(a) != {"link.stalled_by_link"} or set(a) - set(b):
            raise AssertionError(f"obs-sim {label}: stats fields "
                                 f"{set(a) ^ set(b)}")
        for key in a:
            if a[key].dtype.kind != "f" and not np.array_equal(a[key],
                                                               b[key]):
                raise AssertionError(f"obs-sim {label}: the recorder "
                                     f"changed {key}")
        floats_equal = all(np.array_equal(a[k], b[k]) for k in a
                           if a[k].dtype.kind == "f")
        if not torch.equal(st_off.neuron.v, st_on.neuron.v):
            raise AssertionError(f"obs-sim {label}: the recorder changed v")
        for s in range(S):
            for w, row in enumerate(obs.ring_rows(obs.ring_shard(ring, s))):
                for f in obs.COUNTER_FIELDS:
                    if row["counters"][f] != int(b["link." + f][s, w]):
                        raise AssertionError(
                            f"obs-sim {label}: ring shard {s} window {w} "
                            f"{f} {row['counters'][f]} != LinkStats "
                            f"{int(b['link.' + f][s, w])}")
        rows = obs.global_rows(ring, S)
        if [r["window"] for r in rows] != list(range(-1, N_WINDOWS - 1)):
            raise AssertionError(f"obs-sim {label}: ring windows "
                                 f"{[r['window'] for r in rows]}")
        deferred = b["link.deferred_events"].sum(0)
        for w, row in enumerate(rows):
            if sum(row["stalled_by_link"]) != int(deferred[w]) or \
                    row["stalled_by_link"] != \
                    b["link.stalled_by_link"][0, w].tolist():
                raise AssertionError(f"obs-sim {label}: window {w} stall "
                                     f"table != the deferred events")
        fmt = lambda xs: " / ".join(f"{x:.3f}" for x in xs)
        print(f"obs-sim {label} [{smi}]: ms per window, in the order off, "
              f"on, on, off: recorder off {fmt(walls[False])}, on "
              f"{fmt(walls[True])} (host clock, 25 windows); launches "
              f"{launches} in every run; every integer "
              f"WindowStats field and v equal off vs on (float fields "
              f"{'equal too' if floats_equal else 'NOT all equal'}); ring "
              f"== LinkStats on {len(obs.COUNTER_FIELDS)} counters x "
              f"{N_WINDOWS} windows x {S} shards; stall table == deferred "
              f"({int(deferred.sum())} events) in every window")
        per_off = window_functions(run_off, state0, 3)
        per_on = window_functions(run_on, state0, 3)
        print(f"obs-sim {label}: device functions per credited window, "
              f"recorder off {per_off}, on {per_on}")
        reg = metrics.Registry()
        metrics.export_link_stats(reg, stats_on.link, backend="torus3d")
        run_dir = report.write_run_dir(
            str(OBS_DIR / ("sim_fault" if fault else "sim_healthy")),
            meta={"kind": "sim", "dims": list(dims), "n_shards": S,
                  "windows": N_WINDOWS,
                  "window_us": cfg.window * cfg.step_us,
                  "link_credits": cfg.link_credits,
                  "notify_latency": cfg.notify_latency},
            recorder_rows=rows,
            fault_events=faults.transitions(sched) if fault else None,
            registry=reg)
        built = report.build_report(run_dir)
        metrics.parse_prometheus((Path(run_dir) / "metrics.prom")
                                 .read_text())
        if not built["top_links"]:
            raise AssertionError(f"obs-sim {label}: no congested link")
        if fault:
            down = [e for e in built["faults"] if e["event"] == "link_down"]
            at2 = [e for e in built["timeline"] if e["window"] == 2][0]
            if not down or down[0]["window"] != 2 or not at2["events"]:
                raise AssertionError(f"obs-sim {label}: the link_down "
                                     f"transition is not at window 2")
        print(f"obs-sim {label}: run directory {run_dir}; top congested "
              f"links " + ", ".join(f"{l['label']} {l['stalled_events']}"
                                    for l in built["top_links"][:4])
              + (f"; link_down {down[0]['links']} at window "
                 f"{down[0]['window']}" if fault else ""))
    return total


def run_obs_serve(smi: str, solo):
    """obs-serve: main path 4's contended run (192 windows) with the flight
    recorder (depth 256) and a tracer, beside a plain contended run in the
    same call: BENCH_serve.json's model outputs and QoS factor (against
    main path 4's solo run), the launches per window, the ring's
    delivered totals against the ledger, a valid trace with spans on all
    three tracks and every window instant among the ring's windows, a run
    directory with parsable metrics and both tenants, and ms per served
    window, events/s and device functions per served window, instrumented
    and not.  -> launches of the instrumented run."""
    from repro_torch import obs
    from repro_torch.kernels import dispatch
    from repro_torch.obs import metrics, report, spans
    bench = {r["op"]: r for r in json.loads(
        (ROOT / "BENCH_serve.json").read_text())}
    runs = {}
    for label, instrumented in (("plain", False), ("instrumented", True)):
        tracer = spans.Tracer() if instrumented else None
        eng = serve_engine("cuda", True, recorder=obs.RecorderConfig(
            depth=OBS_SERVE_DEPTH) if instrumented else None, tracer=tracer)
        eng.warmup()
        torch.cuda.synchronize()
        dispatch.reset_launches()
        rep = eng.run(SERVE_SEGMENTS, timeout=900)
        launches = dict(dispatch.LAUNCHES)
        entries = dict(dispatch.ENTRY_LAUNCHES)
        n_win = rep.windows + rep.drain_windows
        want = {"repro_admission_tenants": n_win,
                "repro_tenant_exchange": n_win, "repro_torus_rotate": 2,
                "repro_wire_encode": n_win + 1,
                "repro_wire_decode": n_win + 2}
        if entries != want:
            raise AssertionError(f"obs-serve {label}: launches by entry "
                                 f"point {entries} != {want}")
        runs[label] = (eng, rep, launches)
        print(f"obs-serve {label} [{smi}]: {rep.events_per_s:.0f} events/s, "
              f"{rep.wall_s * 1e3 / rep.windows:.3f} ms per served window "
              f"(host clock), {rep.windows} + {rep.drain_windows} drain "
              f"windows; launches per window: admission, exchange "
              f"epilogue, encode, decode 1 each ({entries})")
    eng, rep, launches = runs["instrumented"]
    plain = runs["plain"][1]
    for t, d in enumerate(rep.tenants):
        b = bench[f"tenant/{d.name}"]
        got = [int(rep.injected[t]), int(rep.delivered[t]),
               int(rep.shed[t]), int(rep.clipped[t])]
        if got != [b["injected"], b["delivered"], b["shed"], b["clipped"]]:
            raise AssertionError(f"obs-serve: {d.name} {got} != "
                                 f"BENCH_serve.json")
        if not (np.array_equal(d.hist, plain.tenants[t].hist)
                and got[:3] == [int(plain.injected[t]),
                                int(plain.delivered[t]),
                                int(plain.shed[t])]):
            raise AssertionError(f"obs-serve: {d.name} differs from the "
                                 f"plain run")
    factor = rep.tenants[0].p99_us / max(solo.tenants[0].p99_us, 1e-9)
    if factor != bench["qos/quiet_p99"]["factor"]:
        raise AssertionError(f"obs-serve: QoS factor {factor}")
    rows = eng.recorder_rows()
    totals = obs.counter_totals(rows)
    if not (np.array_equal(totals["delivered_events"], rep.delivered)
            and np.array_equal(rep.delivered, eng.ledger.delivered)):
        raise AssertionError(f"obs-serve: ring delivered "
                             f"{totals['delivered_events']} != ledger "
                             f"{rep.delivered}")
    for row in rows:
        if sum(row["stalled_by_link"]) != sum(
                row["counters"]["deferred_events"]):
            raise AssertionError(f"obs-serve: window {row['window']} stall "
                                 f"table != its deferred events")
    trace = eng.tracer.to_dict()
    problems = spans.validate_trace(trace)
    if problems:
        raise AssertionError(f"obs-serve: trace problems {problems[:5]}")
    names = spans.thread_names(trace)
    tracks = {names[e["tid"]] for e in trace["traceEvents"]
              if e["ph"] == "X"}
    if not {"spike-ingest", "spike-device"} <= tracks or "device" not in {
            names[e["tid"]] for e in trace["traceEvents"]
            if e["name"] == "window"}:
        raise AssertionError(f"obs-serve: spans on tracks {tracks}")
    windows = [e["args"]["window"] for e in trace["traceEvents"]
               if e["name"] == "window"]
    if not set(windows) <= {r["window"] for r in rows} or \
            len(windows) != rep.windows + rep.drain_windows:
        raise AssertionError("obs-serve: window instants do not match the "
                             "ring")
    run_dir = report.write_engine_run(str(OBS_DIR / "serve"), eng, rep)
    metrics.parse_prometheus((OBS_DIR / "serve" / "metrics.prom")
                             .read_text())
    built = report.build_report(run_dir)
    if {t["tenant"] for t in built["tenants"]} != {"quiet", "hot"}:
        raise AssertionError("obs-serve: the report lacks a tenant")
    print(f"obs-serve: BENCH_serve.json's outputs from the instrumented "
          f"engine (quiet {rep.injected[0]} / {rep.delivered[0]} / "
          f"{rep.shed[0]} / {rep.clipped[0]}, hot {rep.injected[1]} / "
          f"{rep.delivered[1]} / {rep.shed[1]} / {rep.clipped[1]}, QoS "
          f"factor {factor:.3f}); ring delivered == ledger "
          f"{rep.delivered.tolist()} over {len(rows)} windows; trace valid, "
          f"{len(trace['traceEvents'])} events on {sorted(tracks)}, "
          f"{len(windows)} window instants; run directory {run_dir}; top "
          f"links " + ", ".join(f"{l['label']} {l['stalled_events']}"
                                for l in built["top_links"][:4]))
    print(f"[{smi}] device functions per served window, plain then "
          f"instrumented:")
    for label, instrumented in (("plain", False), ("instrumented", True)):
        e = serve_engine("cuda", True, recorder=obs.RecorderConfig(
            depth=OBS_SERVE_DEPTH) if instrumented else None,
            tracer=spans.Tracer() if instrumented else None)
        e.warmup()
        _serve_segment_profile(e, 4)
    return launches


# ---------------------------------------------------------------------------
# Phases 6 and 7: Mamba-2 serving.
# ---------------------------------------------------------------------------

MAMBA_ARCH = "mamba2-2.7b"
MAMBA_REQUESTS = 8
MAMBA_SLOTS = 4
MAMBA_PROMPTS = (300, 601)        # prompt lengths drawn from [300, 600]
MAMBA_NEW = 16
# Prefill + decode against the full forward (decode_vs_full), with the
# CACHE_FAULTS planted to show what each reading sees; the run fails if a
# limit misses a planted fault.  Logits, in units of the row RMS: at the
# reference test's depth of 2 layers at its tolerance 5e-2
# (tests/test_models.py).  Over all 64 layers a clean decode reads 0.115
# and a zeroed or stale SSD state 0.125-0.132 (H100), so there the logits
# are held only on the argmax of rows whose top-2 margin exceeds
# MARGIN_DEEP, twice the clean reading rounded up.  States, max |dstate|
# in units of the layer's state RMS, separate every fault: clean 0.12 and
# 1.48, faults from 15.5 and 41.2 up, at 2 and 64 layers; the limits
# TOL_STATE and TOL_STATE_DEEP lie between.
TOL_MODEL = 5e-2
MARGIN_DEEP = 0.25
TOL_STATE = 1.0
TOL_STATE_DEEP = 8.0
CACHE_FAULTS = ("SSD state zeroed", "SSD state one token stale",
                "conv cache one token stale")


def decode_vs_full(model, params, toks, nxt):
    """Logits of a prefill over ``toks`` and one decode step of ``nxt``
    against the full forward over both (the reference's own check,
    tests/test_models.py:141), as max |dlogit| at the last token in units
    of the full forward's row RMS; also with each of CACHE_FAULTS planted
    in the caches between prefill and decode.  Returns ({case: reading},
    the clean decode's logits, the full forward's logits)."""
    dev = toks.device
    ext = torch.cat([toks, nxt], 1)
    l_full = model.logits(params, model.hidden(
        params, {"tokens": ext})[0][:, -1:, :])
    rms = l_full.pow(2).mean(-1, keepdim=True).sqrt()
    fresh = lambda: model.init_caches(len(toks), ext.shape[1], device=dev)
    _, good = model.prefill(params, {"tokens": toks}, fresh())
    _, stale = model.prefill(params, {"tokens": toks[:, :-1]}, fresh())
    _, whole = model.prefill(params, {"tokens": ext}, fresh())
    s_rms = whole.state.pow(2).mean((1, 2, 3, 4), keepdim=True).sqrt()
    cases = dict(zip(("clean",) + CACHE_FAULTS, (
        good, good._replace(state=torch.zeros_like(good.state)),
        good._replace(state=stale.state), good._replace(conv=stale.conv))))
    errs, l_clean = {}, None
    for name, caches in cases.items():
        l_dec, new = model.decode(params, caches, nxt)
        errs[name] = (float(((l_dec - l_full).abs() / rms).max()),
                      float(((new.state - whole.state).abs() / s_rms).max()))
        l_clean = l_dec if l_clean is None else l_clean
    return errs, l_clean, l_full


def tree_to(tree, device):
    """A tree of dicts and (named) tuples of tensors, moved."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_to(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree.to(device)


def _margins(model, params, reqs, out, scfg):
    """Top-2 logit margin of every token of ``out``, replayed through
    prefill and decode with the generated tokens fed back."""
    margins = {}
    for w0 in range(0, len(reqs), scfg.slots):
        wave = reqs[w0:w0 + scfg.slots]
        S = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(wave), S), np.int64)
        for j, r in enumerate(wave):
            toks[j, S - len(r.prompt):] = r.prompt
        device = params["embed"].device
        caches = model.init_caches(len(wave), scfg.max_len, device=device)
        h, caches = model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(device)}, caches)
        steps = [model.logits(params, h[:, -1:, :])[:, -1]]
        for t in range(1, max(len(out[r.rid]) for r in wave)):
            fed = torch.tensor([[int(out[r.rid][t - 1])
                                 if t - 1 < len(out[r.rid]) else scfg.eos_id]
                                for r in wave], device=device)
            logits, caches = model.decode(params, caches, fed)
            steps.append(logits[:, -1])
        for j, r in enumerate(wave):
            top = torch.stack([s[j] for s in steps[:len(out[r.rid])]]) \
                .topk(2, dim=-1).values.cpu()
            margins[r.rid] = (top[:, 0] - top[:, 1]).numpy()
    return margins


def check_mamba_small():
    """The reduced Mamba-2 (2 layers, d_model 64, chunk 16) on the card
    against the same model on the CPU: hidden states, prefill caches and
    one decode step at the model tolerance, and greedy serving with the
    same tokens wherever the CPU run's top-2 logit margin exceeds it."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = reduced(get_config(MAMBA_ARCH))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params["embed"] = params["embed"] * 0.25   # let the blocks pick tokens
    card = tree_to(params, "cuda")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))

    def close(a, b, what):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=TOL_MODEL,
                                   atol=TOL_MODEL,
                                   msg=lambda m: f"mamba {what}: {m}")

    dispatch.reset_launches()
    close(model.hidden(card, {"tokens": tokens.cuda()})[0],
          model.hidden(params, {"tokens": tokens})[0], "hidden")
    c_gpu = model.init_caches(2, 64, device="cuda")
    c_cpu = model.init_caches(2, 64, device="cpu")
    h_gpu, c_gpu = model.prefill(card, {"tokens": tokens.cuda()}, c_gpu)
    h_cpu, c_cpu = model.prefill(params, {"tokens": tokens}, c_cpu)
    close(h_gpu, h_cpu, "prefill hidden")
    close(c_gpu.state, c_cpu.state, "prefill state")
    close(c_gpu.conv, c_cpu.conv, "prefill conv")
    nxt = tokens[:, :1]
    l_gpu, c_gpu = model.decode(card, c_gpu, nxt.cuda())
    l_cpu, c_cpu = model.decode(params, c_cpu, nxt)
    close(l_gpu, l_cpu, "decode logits")
    close(c_gpu.state, c_cpu.state, "decode state")
    scfg = ServeConfig(slots=2, max_len=64, max_new_tokens=8)
    reqs = [Request(i, rng.integers(3, cfg.vocab, n).astype(np.int32))
            for i, n in enumerate((5, 20, 33))]
    out_gpu = Engine(model, scfg).generate_batch(card, reqs)
    launches = dict(dispatch.LAUNCHES)
    out_cpu = Engine(model, scfg).generate_batch(params, reqs)
    margins = _margins(model, params, reqs, out_cpu, scfg)
    checked = 0
    for r in reqs:
        got, want, margin = out_gpu[r.rid], out_cpu[r.rid], margins[r.rid]
        for t in range(min(len(got), len(want))):
            if margin[t] > TOL_MODEL:
                if got[t] != want[t]:
                    raise AssertionError(f"mamba serve card vs CPU: request "
                                         f"{r.rid} token {t} differs at "
                                         f"margin {margin[t]}")
                checked += 1
            elif got[t] != want[t]:
                break
        else:
            if len(got) != len(want):
                raise AssertionError(f"mamba serve: request {r.rid} length")
    # the blocks compute in bf16 whatever the parameters' dtype, so the
    # tensor-core kernel runs here
    if set(launches) != {"ssd_chunk"} or checked == 0:
        raise AssertionError(f"mamba small: launches {launches} (want the "
                             f"tensor-core kernel only) or no token "
                             f"compared")
    print(f"mamba2 reduced (2 layers, chunk 16), card vs CPU: hidden, "
          f"prefill, decode within {TOL_MODEL}; served 3 requests with "
          f"{checked} decisive tokens equal; launches {launches}")


def run_ssd_f32_path():
    """The f32 route of kernel E: the chunked SSD scan that every Mamba-2
    block calls (``models/ssm.py:ssd_chunked``) on f32 inputs at the
    serving path's widths (4 slots x 512 tokens, 80 heads x 64, one group
    of d_state 128, chunk 256; inputs from seed 5), card against the same
    scan on the CPU at rtol/atol 2e-4.  Each chunk is one launch of the FMA
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.ssm import dims, ssd_chunked
    cfg = get_config(MAMBA_ARCH)
    s = cfg.ssm
    _, heads, _ = dims(cfg)
    gen = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=gen)
    length = 2 * s.chunk
    ins = (r(MAMBA_SLOTS, length, heads, s.head_dim),
           torch.nn.functional.softplus(r(MAMBA_SLOTS, length, heads)),
           -torch.exp(r(heads) * 0.3),
           r(MAMBA_SLOTS, length, s.n_groups, s.d_state) * 0.3,
           r(MAMBA_SLOTS, length, s.n_groups, s.d_state) * 0.3)
    card = [t.cuda() for t in ins]
    torch.cuda.synchronize()
    dispatch.reset_launches()
    got = ssd_chunked(*card, s.chunk)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    want = ssd_chunked(*ins, s.chunk)
    for name, a, b in zip(("y", "state"), got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"f32 scan {name}: {m}")
    if launches != {"ssd_chunk_f32": length // s.chunk}:
        raise AssertionError(f"f32 scan launches {launches}")
    print(f"chunked SSD scan in f32 ({MAMBA_SLOTS} x {length} tokens, "
          f"{heads} heads x {s.head_dim}, d_state {s.d_state}), card == "
          f"CPU at 2e-4; launches {launches}")
    return launches


def run_mamba_main_path():
    """Serve mamba2-2.7b at its published width on the card: random bf16
    weights from seed 0, 8 requests of 300-600 prompt tokens through 4
    slots, 16 new tokens each (greedy)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    from repro_torch.models.modules import param_bytes, param_count
    from repro_torch.models.ssm import dims
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = get_config(MAMBA_ARCH)
    model = build(cfg)
    _, n_heads, _ = dims(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0),
                        param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_heads} heads x {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, "
          f"chunk {cfg.ssm.chunk}, vocab {cfg.vocab}; "
          f"{param_count(model.specs()) / 1e9:.3f} B parameters, "
          f"{param_bytes(model.specs(), torch.bfloat16) / 1e9:.2f} GB in "
          f"bf16, drawn from seed 0 on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    finite = []           # device booleans, read after the run

    def prefill(p, batch, caches, rt=None):
        h, caches = model.prefill(p, batch, caches, rt)
        finite.append(torch.isfinite(h).all())
        return h, caches

    def decode(p, caches, tokens, rt=None):
        logits, caches = model.decode(p, caches, tokens, rt)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    checked = dataclasses.replace(model, prefill=prefill, decode=decode)
    rng = np.random.default_rng(0)
    lengths = rng.integers(*MAMBA_PROMPTS, MAMBA_REQUESTS)
    reqs = [Request(i, rng.integers(3, cfg.vocab, int(n)).astype(np.int32))
            for i, n in enumerate(lengths)]
    # warm-up (library handles, allocator): one short request
    Engine(model, ServeConfig(slots=1, max_len=64, max_new_tokens=2)) \
        .generate_batch(params, [Request(-1, reqs[0].prompt[:40])])
    eng = Engine(checked, ServeConfig(slots=MAMBA_SLOTS, max_len=1024,
                                      max_new_tokens=MAMBA_NEW))
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = eng.generate_batch(params, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    chunks = [-(-w.prompt_len // cfg.ssm.chunk) for w in eng.waves]
    for i, (w, nc) in enumerate(zip(eng.waves, chunks)):
        print(f"wave {i}: {w.batch} requests, prompt {w.prompt_len} tokens "
              f"padded ({nc} chunks): prefill {w.prefill_s * 1e3:.1f} ms "
              f"({w.batch * w.prompt_len / w.prefill_s:.0f} prompt tokens/s)"
              f"; {w.decode_steps} decode steps, "
              f"{w.decode_s * 1e3 / max(w.decode_steps, 1):.2f} ms per step "
              f"({w.batch} tokens per step)")
    n_gen = sum(len(v) for v in out.values())
    print(f"served {len(reqs)} requests ({int(lengths.sum())} prompt "
          f"tokens, {n_gen} generated) in {wall:.2f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB")

    # the tensor-core kernel only: an "ssd_chunk_f32" key fails it too
    want = {"ssd_chunk": cfg.n_layers * sum(chunks)}
    if launches != want:
        raise AssertionError(f"mamba launches {launches} != {want}")
    if not finite or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite hidden states or logits")
    for r in reqs:
        seq = out[r.rid]
        if not (1 <= len(seq) <= MAMBA_NEW and (seq >= 0).all()
                and (seq < cfg.vocab).all()):
            raise AssertionError(f"request {r.rid}: bad output {seq}")
    print(f"launches on the serving path: {launches} = {cfg.n_layers} "
          f"layers x {sum(chunks)} chunks")

    # the same requests with a tracer: the serve spans, the same tokens
    from repro_torch.obs import spans
    tracer = spans.Tracer()
    traced = Engine(model, ServeConfig(slots=MAMBA_SLOTS, max_len=1024,
                                       max_new_tokens=MAMBA_NEW),
                    tracer=tracer).generate_batch(params, reqs)
    trace = tracer.to_dict()
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    if spans.validate_trace(trace) or names != ["serve/prefill",
                                                "serve/decode"] * len(
                                                    eng.waves):
        raise AssertionError(f"traced serving: spans {names}, problems "
                             f"{spans.validate_trace(trace)}")
    if any(not np.array_equal(traced[r.rid], out[r.rid]) for r in reqs):
        raise AssertionError("traced serving gave other tokens")
    print(f"traced serving: {names.count('serve/prefill')} serve/prefill "
          f"and {names.count('serve/decode')} serve/decode spans on track "
          f"{sorted(spans.thread_names(trace).values())}, trace valid, "
          f"tokens equal the untraced run's")

    wave = reqs[:MAMBA_SLOTS]
    S = eng.waves[0].prompt_len
    toks = np.zeros((len(wave), S), np.int64)
    for j, r in enumerate(wave):
        toks[j, S - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    nxt = torch.tensor([[int(out[r.rid][0])] for r in wave],
                       device=toks.device)
    # over the first 2 layers at full width (the reference test's depth)
    # and over all the layers
    shallow = build(dataclasses.replace(cfg, n_layers=2))
    errs2, _, _ = decode_vs_full(shallow, dict(params, blocks={
        k: v[:2] for k, v in params["blocks"].items()}), toks, nxt)
    errs, l_dec, l_full = decode_vs_full(model, params, toks, nxt)
    top = l_full.topk(2, dim=-1).values
    decisive = (top[..., 0] - top[..., 1]) > MARGIN_DEEP * \
        l_full.pow(2).mean(-1).sqrt()
    flips = int((decisive & (l_dec.argmax(-1) != l_full.argmax(-1))).sum())
    print(f"prefill + decode vs full forward ({len(wave)} x {S + 1} tokens): "
          f"max |dlogit| in units of the row RMS / max |dstate| in units of "
          f"the layer's state RMS; at {cfg.n_layers} layers {flips} argmax "
          f"flips among {int(decisive.sum())} rows of margin > "
          f"{MARGIN_DEEP}:")
    for depth, e, tols in ((2, errs2, (TOL_MODEL, TOL_STATE)),
                           (cfg.n_layers, errs,
                            (float("inf"), TOL_STATE_DEEP))):
        print(f"  {depth} layers (limits {tols[0]} / {tols[1]}): " +
              ", ".join(f"{name} {v[0]:.5f} / {v[1]:.5f}"
                        for name, v in e.items()))
        blind = [name for name in CACHE_FAULTS
                 if not any(v > t for v, t in zip(e[name], tols))]
        if blind:
            raise AssertionError(f"at {depth} layers the limits {tols} do "
                                 f"not see the planted faults {blind}")
        if not all(v <= t for v, t in zip(e["clean"], tols)):
            raise AssertionError("decode through the cache disagrees with "
                                 "the full forward")
    if flips:
        raise AssertionError("decode through the cache flips a decisive "
                             "argmax of the full forward")
    profile_decode(model, params, {"tokens": toks}, 1024, cfg.name)
    return launches


# ---------------------------------------------------------------------------
# Main path 5: the cycle-level bucket and ring-buffer models (kernel G).
# ---------------------------------------------------------------------------

RING_STEPS = 2000                 # benchmarks/bench_ringbuffer.py
LONG_TRACE = dict(T=100_000, E=4, n_buckets=16, n_dest=1024, capacity=124,
                  flush_margin=16, queue=8)
TS_MASK = (1 << 15) - 1


def _np_words(addr, ts, valid=None) -> torch.Tensor:
    from repro_torch.core import events as ev
    return ev.pack(torch.from_numpy(np.asarray(addr)),
                   torch.from_numpy(np.asarray(ts)),
                   None if valid is None else torch.from_numpy(
                       np.asarray(valid)))


def cycle_traces() -> dict:
    """Every bucket trace of main path 5, made with numpy from a seed:
    name -> (BucketConfig, words, dests) on the CPU.  The sweeps of
    benchmarks/bench_renaming.py (8 + 4 traces, T 1200) and
    bench_aggregation.py:model_throughput (T 2000, rate 1.0) with the
    benches' configurations and trace shapes, tests/test_core.py's two
    paper-claim traces, and the long trace for timing G: T 100,000, 4
    arrivals a cycle at rate 0.5, 16 buckets, 1,024 destinations, a working
    set of 24 destinations that moves every 500 cycles, timestamps 200-263
    ahead that wrap the 15-bit ring three times."""
    from repro_torch.core import bucket as bk
    traces = {}

    def renaming(n_buckets, n_dest, margin, T=1200, seed=0):
        cfg = bk.BucketConfig(n_buckets=n_buckets, capacity=124,
                              n_dest=max(n_dest, 4), flush_margin=margin,
                              queue=8)
        dests = np.random.default_rng(seed).integers(0, n_dest, (T, 1))
        ts = (np.arange(T).reshape(T, 1) + 400) & TS_MASK
        return cfg, _np_words(dests, ts), torch.from_numpy(
            dests.astype(np.int32))

    for n_buckets in (4, 16):
        for n_dest in (2, 8, 32, 128):
            traces[f"renaming/buckets={n_buckets}/dests={n_dest}"] = \
                renaming(n_buckets, n_dest, 16)
    for margin in (2, 8, 32, 128):
        traces[f"renaming/margin={margin}"] = renaming(16, 16, margin)
    T = 2000
    rng = np.random.default_rng(0)
    for name, n_dest in (("aggregated", 4), ("unaggregated", 256)):
        cfg = bk.BucketConfig(n_buckets=8, capacity=124, n_dest=n_dest,
                              flush_margin=8 if n_dest == 4 else 10_000,
                              queue=8)
        if n_dest == 4:
            dests = rng.integers(0, n_dest, (T, 1))
            ts = (np.arange(T).reshape(T, 1) + 300) & TS_MASK
        else:
            dests = (np.arange(T).reshape(T, 1) * 97) % n_dest
            ts = np.ones((T, 1), np.int64)
        valid = rng.random((T, 1)) < 1.0
        traces[f"aggregation/{name}"] = (cfg, _np_words(dests, ts, valid),
                                         torch.from_numpy(
                                             dests.astype(np.int32)))
    addr = np.arange(400).reshape(400, 1) % 256
    traces["claim/single_event"] = (
        bk.BucketConfig(n_buckets=8, capacity=124, n_dest=256,
                        flush_margin=10_000),
        _np_words(addr, np.ones((400, 1), np.int64)),
        torch.from_numpy(addr.astype(np.int32)))
    traces["claim/aggregated"] = (
        bk.BucketConfig(n_buckets=4, capacity=124, n_dest=4, flush_margin=4,
                        queue=8),
        _np_words(np.zeros((600, 1), np.int64),
                  (np.arange(600).reshape(600, 1) + 200) & TS_MASK),
        torch.zeros((600, 1), dtype=torch.int32))
    L = LONG_TRACE
    rng = np.random.default_rng(5)
    t = np.arange(L["T"]).reshape(-1, 1)
    dests = ((t // 500) * 7 + rng.integers(0, 24, (L["T"], L["E"]))) \
        % L["n_dest"]
    ts = (t + 200 + rng.integers(0, 64, (L["T"], L["E"]))) & TS_MASK
    traces["long"] = (
        bk.BucketConfig(n_buckets=L["n_buckets"], capacity=L["capacity"],
                        n_dest=L["n_dest"], flush_margin=L["flush_margin"],
                        queue=L["queue"]),
        _np_words(rng.integers(0, 1 << 12, (L["T"], L["E"])), ts,
                  rng.random((L["T"], L["E"])) < 0.5),
        torch.from_numpy(dests.astype(np.int32)))
    return traces


def ring_cases() -> dict:
    """benchmarks/bench_ringbuffer.py's 18 + 3 runs (2,000 steps, rate 1):
    name -> RingConfig."""
    from repro_torch.core import flow_control as fc
    cases = {f"lat={lat}/size={size}": fc.RingConfig(size=size,
                                                     notify_latency=lat)
             for lat in (4, 8, 16) for size in (2, 4, 8, 16, 32, 64)}
    for batch in (1, 4, 16):
        cases[f"notify_batch={batch}"] = fc.RingConfig(
            size=32, notify_latency=8, notify_batch=batch)
    return cases


def _bucket_fields(st, out) -> list:
    return list(st) + list(out)


def check_cycle_small():
    """Kernel G on small traces that reach the model's corners, card
    against CPU bit for bit: the clipped append (E 2, capacity 16, two
    destinations), invalid words and negative / too large destinations,
    timestamps wrapping the 15-bit ring, all-urgent deadlines with a queue
    of 1, 32 arrivals a cycle, 40 buckets (more than a warp's lanes), a
    capacity of 1, and a map table of 2^14 destinations (dynamic shared
    memory above 48 KB); the ring form at latencies 1-16, batches 1 / 4 /
    16, rates below 1 and consumers faster than 1."""
    from repro_torch.core import bucket as bk
    from repro_torch.core import flow_control as fc
    from repro_torch.kernels import dispatch
    cases = [  # name, cfg, T, E, dests drawn in [lo, hi), ts (base, spread),
               # valid rate
        ("clipped append", bk.BucketConfig(4, 16, 2, 2, 4), 200, 2, (0, 2),
         (3000, 4), 1.0),
        ("invalid words, dest -3..11", bk.BucketConfig(4, 8, 8, 8, 4), 150,
         3, (-3, 12), (100, 50), 0.6),
        ("15-bit wrap", bk.BucketConfig(4, 16, 8, 6, 4), 300, 2, (0, 8),
         (TS_MASK - 100, 30), 1.0),
        ("all urgent, queue 1", bk.BucketConfig(4, 32, 16, 16, 1), 200, 3,
         (0, 16), (-40, 40), 1.0),
        ("32 arrivals", bk.BucketConfig(8, 64, 64, 8, 4), 60, 32, (0, 64),
         (100, 50), 0.8),
        ("40 buckets", bk.BucketConfig(40, 16, 128, 8, 6), 300, 2, (0, 128),
         (100, 50), 1.0),
        ("capacity 1", bk.BucketConfig(4, 1, 8, 4, 2), 100, 2, (0, 8),
         (100, 20), 1.0),
        ("2^14 destinations", bk.BucketConfig(16, 124, 1 << 14, 16, 8), 400,
         4, (0, 1 << 14), (200, 64), 1.0),
    ]
    dispatch.reset_launches()
    for i, (name, cfg, T, E, (lo, hi), (base, spread), rate) in \
            enumerate(cases):
        rng = np.random.default_rng(100 + i)
        dests = torch.from_numpy(rng.integers(lo, hi, (T, E)).astype(
            np.int32))
        ts = (np.arange(T).reshape(T, 1) + base
              + rng.integers(0, spread, (T, E))) & TS_MASK
        words = _np_words(rng.integers(0, 4096, (T, E)), ts,
                          rng.random((T, E)) < rate)
        got = bk.run_trace(cfg, words.cuda(), dests.cuda())
        want = bk.run_trace(cfg, words, dests)
        torch.cuda.synchronize()
        require_equal(f"bucket_trace small {name}",
                      [(a.cpu(), b) for a, b in zip(_bucket_fields(*got),
                                                    _bucket_fields(*want))])
        if name == "clipped append" and \
                int(want[1].sent_count.max()) != cfg.capacity + 1:
            raise AssertionError("the clipped-append trace missed its case")
    rings = [fc.RingConfig(2, 1, 1), fc.RingConfig(8, 3, 4),
             fc.RingConfig(24, 16, 16), fc.RingConfig(1, 2, 1)]
    for i, cfg in enumerate(rings):
        for rate, crate in ((1.0, 1), (0.6, 2)):
            want_in = (torch.rand((500,), generator=torch.Generator()
                                  .manual_seed(i)) < rate).to(torch.int32)
            got = fc.run(cfg, 500, rate, crate, want=want_in.cuda(),
                         device="cuda")
            want = fc.run(cfg, 500, rate, crate, want=want_in, device="cpu")
            require_equal(f"ring_run small {cfg}", [
                (a.cpu(), b) for a, b in zip(list(got[0]) + list(got[1]),
                                             list(want[0]) + list(want[1]))])
    launches = dict(dispatch.LAUNCHES)
    if launches != {"bucket_trace": len(cases), "ring_run": 2 * len(rings)}:
        raise AssertionError(f"cycle small launches {launches}")
    print(f"kernel G, card vs CPU bit for bit: {len(cases)} bucket traces "
          f"({', '.join(c[0] for c in cases)}), {2 * len(rings)} ring runs; "
          f"launches {launches}")


def run_cycle_models(smi: str):
    """Main path 5: every trace of :func:`cycle_traces` through
    ``bucket.run_trace`` and every run of :func:`ring_cases` through
    ``flow_control.run`` on the card (one launch of kernel G each), bit
    for bit against the plain versions on the CPU on every output and state
    field; the benches' model outputs and the paper's two §3.1 claims; G's
    times (CUDA graph) beside its bound and the plain versions' times on
    the card.  Returns (launches, [bucket record, ring record])."""
    from repro_torch.core import bucket as bk
    from repro_torch.core import flow_control as fc
    from repro_torch.kernels import dispatch
    traces = cycle_traces()
    rings = ring_cases()
    card = {k: (cfg, w.cuda(), d.cuda()) for k, (cfg, w, d) in traces.items()}
    wants = {k: torch.ones((RING_STEPS,), dtype=torch.int32) for k in rings}
    wants_card = {k: w.cuda() for k, w in wants.items()}
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    outs = {k: bk.run_trace(*v) for k, v in card.items()}
    ring_outs = {k: fc.run(cfg, RING_STEPS, want=wants_card[k],
                           device="cuda") for k, cfg in rings.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    want = {"bucket_trace": len(traces), "ring_run": len(rings)}
    if launches != want:
        raise AssertionError(f"cycle models launches {launches} != {want}")
    print(f"main path 5: {len(traces)} bucket traces and {len(rings)} ring "
          f"runs on the card in {wall * 1e3:.1f} ms (host clock, one launch "
          f"each: {launches})")

    t1 = time.perf_counter()
    for k, (cfg, w, d) in traces.items():
        plain = bk.run_trace(cfg, w, d)
        require_equal(f"bucket_trace {k}", [
            (a.cpu(), b) for a, b in zip(_bucket_fields(*outs[k]),
                                         _bucket_fields(*plain))])
    for k, cfg in rings.items():
        st, stats = fc.run(cfg, RING_STEPS, want=wants[k], device="cpu")
        require_equal(f"ring_run {k}", [
            (a.cpu(), b) for a, b in zip(list(ring_outs[k][0])
                                         + list(ring_outs[k][1]),
                                         list(st) + list(stats))])
    print(f"kernel G == the plain versions (CPU) bit for bit on every field "
          f"of all {len(traces)} traces and {len(rings)} ring runs (plain "
          f"versions {time.perf_counter() - t1:.1f} s)")

    res = {}
    for k, (cfg, w, d) in traces.items():
        st, out = (tuple(x.cpu() for x in y) for y in outs[k])
        st, out = bk.BucketState(*st), bk.CycleOut(*out)
        T = w.shape[0]
        sent = int(out.sent_count.sum())
        pkts = int((out.sent_dest >= 0).sum())
        offered = int(((w & (1 << 29)) != 0).sum())
        res[k] = dict(sent=sent, thr=sent / T,
                      pkt=sent / pkts if pkts else 0.0,
                      miss=int(out.deadline_miss.sum()),
                      stalled=int(out.stalled.sum()), offered=offered,
                      held=int(st.q_count.sum() + st.fill.sum()), T=T)
    for k, r in res.items():
        if k.startswith("renaming"):
            print(f"  {k}: {r['thr']:.3f} events/cycle, mean packet "
                  f"{r['pkt']:.1f} events, misses {r['miss']}")
    un, ag = res["aggregation/unaggregated"], res["aggregation/aggregated"]
    speedup = ag["thr"] / max(un["thr"], 1e-9)
    for name, r in (("unaggregated", un), ("aggregated", ag)):
        print(f"  aggregation/{name}: {r['thr']:.4f} events/cycle delivered, "
              f"offered {r['offered'] / r['T']:.2f}/cycle, stall fraction "
              f"{r['stalled'] / max(r['offered'], 1):.3f}, mean packet "
              f"{r['pkt']:.1f}")
    one, agg = res["claim/single_event"], res["claim/aggregated"]
    # claim 2 as tests/test_core.py:169-185 words it: the aggregated stream
    # absorbs one event a cycle (nothing stalls, nothing is lost) in large
    # packets.  bench_aggregation.py's delivered-rate speedup is printed as
    # measured: it counts the deadline latency (~300 cycles of 2,000) as
    # lost and is below 2 on the reference too (ROADMAP queue 3).
    print(f"  paper §3.1, claim 1 (single events drain at ~1/2 per cycle): "
          f"bench {un['thr']:.4f}, test_core trace {one['thr']:.4f} events/"
          f"cycle (must lie in [0.3, 0.55]); claim 2 (aggregation keeps up "
          f"with 1 event/cycle): bench {ag['stalled']} of {ag['offered']} "
          f"stalled, test_core trace {agg['stalled']} stalled, "
          f"{agg['sent'] + agg['held']} of {agg['offered']} events sent or "
          f"held, mean packet {agg['pkt']:.1f} (> 30); bench_aggregation's "
          f"delivered-rate speedup {speedup:.3f}x (its note names 2x; the "
          f"reference's own draws give 0.8885 / 0.5025 = 1.768x)")
    if not (0.3 <= un["thr"] <= 0.55 and 0.3 <= one["thr"] <= 0.55
            and ag["stalled"] == 0 and agg["stalled"] == 0
            and agg["pkt"] > 30
            and agg["sent"] + agg["held"] == agg["offered"]):
        raise AssertionError("the paper's §3.1 claims fail on the model")
    lr = res["long"]
    print(f"  long trace (T {lr['T']}, 4 arrivals a cycle): "
          f"{lr['thr']:.4f} events/cycle sent of {lr['offered'] / lr['T']:.3f}"
          f" offered, mean packet {lr['pkt']:.1f}, misses {lr['miss']}, "
          f"stall fraction {lr['stalled'] / max(lr['offered'], 1):.4f}")
    for k, cfg in rings.items():
        stats = ring_outs[k][1]
        thr = int(stats.produced) / RING_STEPS
        bound = min(1.0, cfg.size / (cfg.notify_latency + 1))
        print(f"  ringbuffer/{k}: throughput {thr:.3f} (credit-loop bound "
              f"~{bound:.2f}), stalls {int(stats.stalls)}")

    # times: G in a CUDA graph, the plain versions (Python on host
    # integers, tensors at the boundary) on the card's tensors
    cfg, w, d = card["long"]
    ms, eager = time_ms(lambda: bk.run_trace(cfg, w, d), calls=1, reps=3)
    plain_ms = time_loop(lambda: bk.run_trace_plain(cfg, w, d), calls=1)
    n_valid = int((((w & (1 << 29)) != 0) & (d >= 0)).sum())
    T, E = w.shape
    out_bytes = sum(x.numel() * 4 for x in _bucket_fields(*outs["long"]))
    steps = n_valid + T
    t_chain = steps * SHARED_ROUND_TRIP_CYCLES / SM_CLOCK_HZ * 1e3
    t_bytes = (w.numel() * 8 + out_bytes) / HBM_BYTES_PER_S * 1e3
    bms, by = max((t_bytes, "bytes"), (t_chain, "operations"))
    rcfg, rw, rd = card["renaming/buckets=16/dests=32"]
    r_ms, _ = time_ms(lambda: bk.run_trace(rcfg, rw, rd), calls=10, reps=5)
    r_plain = time_loop(lambda: bk.run_trace_plain(rcfg, rw, rd),
                        calls=1)
    print(f"bucket_trace: the long trace (T {T}, E {E}) {ms:.3f} ms (CUDA "
          f"graph), eager {eager:.3f} ms; plain version {plain_ms:.1f} ms; "
          f"bound {bms:.4f} ms ({steps} dependent steps ({n_valid} valid "
          f"events + {T} port steps) x {SHARED_ROUND_TRIP_CYCLES} cycles at "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz = {t_chain:.4f} ms; "
          f"{w.numel() * 8 + out_bytes} B = {t_bytes:.4f} ms); the "
          f"bench_renaming trace (T 1200, 16 buckets, 32 destinations) "
          f"{r_ms * 1e3:.1f} us, plain {r_plain:.1f} ms ({smi})")
    bucket = dict(name="bucket_trace", route="cuda",
                  source="src/repro_torch/csrc/cycle_models.cu",
                  replaces="none: no TPU kernel (the reference replays with "
                           "lax.scan, src/repro/core/bucket.py:284 "
                           "run_trace)",
                  max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by, library_ms=None, eager_ms=eager,
                  plain_eager_ms=plain_ms,
                  parity=f"bit-exact on every CycleOut and BucketState "
                         f"field ({len(traces)} traces of main path 5 and "
                         f"8 small)")
    key = "lat=8/size=32"
    rcfg = rings[key]
    rw = wants_card[key]
    g_ms, g_eager = time_ms(lambda: fc.run(rcfg, RING_STEPS, want=rw,
                                           device="cuda"), calls=10, reps=5)
    p_ms = time_loop(lambda: fc.run_plain(rcfg, rw, 1), calls=1)
    r_steps = RING_STEPS
    t_chain = r_steps * SHARED_ROUND_TRIP_CYCLES / SM_CLOCK_HZ * 1e3
    n_bytes = rw.numel() * 4 + 4 * (7 + rcfg.notify_latency + rcfg.size)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    rbms, rby = max((t_bytes, "bytes"), (t_chain, "operations"))
    print(f"ring_run ({key}, {RING_STEPS} steps): {g_ms * 1e3:.2f} us (CUDA "
          f"graph), eager {g_eager * 1e3:.2f} us; plain version {p_ms:.1f} "
          f"ms on the card; bound {rbms * 1e3:.2f} us ({r_steps} dependent "
          f"steps x {SHARED_ROUND_TRIP_CYCLES} cycles; {n_bytes} B = "
          f"{t_bytes * 1e3:.4f} us) ({smi})")
    ring = dict(name="ring_run", route="cuda",
                source="src/repro_torch/csrc/cycle_models.cu",
                replaces="none: no TPU kernel (the reference replays with "
                         "lax.scan, src/repro/core/flow_control.py:288 run)",
                max_abs_err=0.0, ms=g_ms, plain_ms=p_ms, bound_ms=rbms,
                bound_by=rby, library_ms=None, eager_ms=g_eager,
                plain_eager_ms=p_ms,
                parity=f"bit-exact on every RingState field and the "
                       f"RunStats sums ({len(rings)} runs of main path 5 "
                       f"and 8 small)")
    return launches, [bucket, ring]


# ---------------------------------------------------------------------------
# Main path 6: the dense transformers; gemma2-9b served at full width.
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen3-32b", "qwen1.5-4b", "gemma2-9b", "minicpm-2b")
GEMMA_ARCH = "gemma2-9b"
GEMMA_LONG = (2, 4400, 4480)      # requests, prompt tokens, max_len
# A finite value planted into layer 0's (local) and layer 1's (global) K and
# V rows (all batch rows and KV heads) between prefill and decode.  Out of
# the local window it must leave the next step's logits bit for bit as
# they were (the window mask excludes it exactly); in the window, and in a
# global layer, it must move the logits (max |dlogit| against the full
# forward, in units of its row RMS) past TOL_DENSE_FAULT, which the clean
# decode must stay under.
# On gemma2-9b at full width (H100, PERF.md §6) the clean decode reads
# 0.10 and the two in-window faults 2.9 and 3.5; the limit lies between.
# The check feeds DECODE_STEPS tokens, one decode step each, and compares
# every step with the full forward at its position.
CACHE_VALUE = 100.0
TOL_DENSE_FAULT = 0.5
DECODE_STEPS = 8


def check_dense_small():
    """The four dense architectures, reduced (2 layers, d_model 64, gemma2's
    window 16), on the card against the same models on the CPU: hidden
    states, prefill (hidden and KV caches) and one decode step (logits and
    caches) at the model tolerance 5e-2; no hand-written kernel runs on
    this path (the reference's attention is plain jnp)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    rng = np.random.default_rng(3)
    dispatch.reset_launches()
    for arch in DENSE_ARCHS:
        cfg = reduced(get_config(arch))
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        params["embed"] = params["embed"] * 0.25
        card = tree_to(params, "cuda")
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
        nxt = tokens[:, :1]

        def close(a, b, what):
            torch.testing.assert_close(
                a.cpu().float(), b.float(), rtol=TOL_MODEL, atol=TOL_MODEL,
                msg=lambda m: f"{arch} {what}: {m}")

        close(model.hidden(card, {"tokens": tokens.cuda()})[0],
              model.hidden(params, {"tokens": tokens})[0], "hidden")
        c_gpu = model.init_caches(2, 48, device="cuda")
        c_cpu = model.init_caches(2, 48, device="cpu")
        h_gpu, c_gpu = model.prefill(card, {"tokens": tokens.cuda()}, c_gpu)
        h_cpu, c_cpu = model.prefill(params, {"tokens": tokens}, c_cpu)
        close(h_gpu, h_cpu, "prefill hidden")
        for name in ("k", "v", "length"):
            close(getattr(c_gpu["blocks"], name),
                  getattr(c_cpu["blocks"], name), f"prefill cache {name}")
        l_gpu, c_gpu = model.decode(card, c_gpu, nxt.cuda())
        l_cpu, c_cpu = model.decode(params, c_cpu, nxt)
        close(l_gpu, l_cpu, "decode logits")
        close(c_gpu["blocks"].k, c_cpu["blocks"].k, "decode cache k")
    if dispatch.LAUNCHES:
        raise AssertionError(f"dense small: launches {dispatch.LAUNCHES}")
    print(f"dense reduced ({', '.join(DENSE_ARCHS)}; 2 layers, d_model 64), "
          f"card vs CPU: hidden, prefill (hidden, caches), decode (logits, "
          f"caches) within {TOL_MODEL}; no kernel launched")


def dense_decode_vs_full(model, params, toks, nxt, max_len, faults=False):
    """Logits of a prefill over ``toks`` into caches of ``max_len``, then one
    decode step for each of the (B, n) tokens ``nxt`` in turn, against the
    full forward over both at the same positions: ({case: max |dlogit| in
    units of the full forward's row RMS}, {case: logits equal to the clean
    decode's bit for bit}, argmax flips among the decisive rows (top-2
    margin > MARGIN_DEEP row RMS), decisive rows).  With ``faults``, the
    first step also with CACHE_VALUE planted at layer 0 (local) more than a
    window behind the decoded token, at layer 0's newest position, and at
    position 0 of layer 1 (global)."""
    n = nxt.shape[1]
    ext = torch.cat([toks, nxt], 1)
    l_full = model.logits(params, model.hidden(
        params, {"tokens": ext})[0][:, -n:, :])
    rms = l_full.pow(2).mean(-1, keepdim=True).sqrt()
    caches = model.init_caches(len(toks), max_len, device=toks.device)
    _, first = model.prefill(params, {"tokens": toks}, caches)
    steps, c = [], first
    for i in range(n):
        logits, c = model.decode(params, c, nxt[:, i:i + 1])
        steps.append(logits)
    l_dec = torch.cat(steps, 1)
    l_again, _ = model.decode(params, first, nxt[:, :1])
    reading = lambda l, ref: float(((l - ref).abs()
                                    / rms[:, :l.shape[1]]).max())
    errs = {"clean": reading(l_dec, l_full)}
    same = {"clean, decoded twice": torch.equal(l_dec[:, :1], l_again)}
    top = l_full.topk(2, dim=-1).values
    decisive = (top[..., 0] - top[..., 1]) > MARGIN_DEEP * rms[..., 0]
    flips = int((decisive & (l_dec.argmax(-1) != l_full.argmax(-1))).sum())
    if faults:
        S, w = toks.shape[1], model.cfg.sliding_window
        fc = first["blocks"]
        for name, (layer, pos) in {
                f"layer 0 (local), position {S - w - 2} (out of window)":
                    (0, S - w - 2),
                f"layer 0 (local), newest position {S - 1}": (0, S - 1),
                "layer 1 (global), position 0": (1, 0)}.items():
            k, v = fc.k.clone(), fc.v.clone()
            k[layer, :, pos] = CACHE_VALUE
            v[layer, :, pos] = CACHE_VALUE
            l_f, _ = model.decode(params, {"blocks": fc._replace(k=k, v=v)},
                                  nxt[:, :1])
            errs[name] = reading(l_f, l_full[:, :1])
            same[name] = torch.equal(l_f, l_dec[:, :1])
            del k, v
    return errs, same, flips, int(decisive.sum())


def _padded(reqs, device):
    S = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), S), np.int64)
    for j, r in enumerate(reqs):
        toks[j, S - len(r.prompt):] = r.prompt
    return torch.from_numpy(toks).to(device)


def run_gemma_main_path(smi: str):
    """Main path 6: serve gemma2-9b at its published widths on the card:
    random bf16 weights from seed 0; 8 requests of 300-600 prompt tokens
    through 4 slots, then 2 requests of 4,400 tokens at max_len 4,480 (the
    local layers' 4,096-token window binds in prefill and decode), 16 new
    tokens each (greedy).  Prefill + decode against the full forward on
    the first wave of each, the planted cache faults on the long one; a
    torch.profiler pass over one prefill wave and 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    from repro_torch.models.modules import param_bytes, param_count
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = get_config(GEMMA_ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0),
                        param_dtype=torch.bfloat16, device="cuda")
    # the tied embedding at std d_model^-0.5 (the init's is 1): logits of
    # unit RMS, so that top-2 margins above MARGIN_DEEP occur; at std 1
    # every logit saturates at the softcap of 30 and no row is decisive
    params["embed"] = params["embed"] * cfg.d_model ** -0.5
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, window {cfg.sliding_window} on "
          f"the even layers; {param_count(model.specs()) / 1e9:.3f} B "
          f"parameters, {param_bytes(model.specs(), torch.bfloat16) / 1e9:.2f}"
          f" GB in bf16, drawn from seed 0 on the card in "
          f"{time.perf_counter() - t0:.2f} s, the embedding scaled by "
          f"d_model^-0.5")
    finite = []

    def prefill(p, batch, caches, rt=None):
        h, caches = model.prefill(p, batch, caches, rt)
        finite.append(torch.isfinite(h).all())
        return h, caches

    def decode(p, caches, tokens, rt=None):
        logits, caches = model.decode(p, caches, tokens, rt)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    checked = dataclasses.replace(model, prefill=prefill, decode=decode)
    rng = np.random.default_rng(0)
    lengths = rng.integers(*MAMBA_PROMPTS, MAMBA_REQUESTS)
    reqs = [Request(i, rng.integers(3, cfg.vocab, int(n)).astype(np.int32))
            for i, n in enumerate(lengths)]
    n_long, s_long, max_long = GEMMA_LONG
    long_reqs = [Request(100 + i, rng.integers(3, cfg.vocab, s_long).astype(
        np.int32)) for i in range(n_long)]
    Engine(model, ServeConfig(slots=1, max_len=64, max_new_tokens=2)) \
        .generate_batch(params, [Request(-1, reqs[0].prompt[:40])])
    engines = [Engine(checked, ServeConfig(slots=MAMBA_SLOTS, max_len=1024,
                                           max_new_tokens=MAMBA_NEW)),
               Engine(checked, ServeConfig(slots=n_long, max_len=max_long,
                                           max_new_tokens=MAMBA_NEW))]
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = engines[0].generate_batch(params, reqs)
    out.update(engines[1].generate_batch(params, long_reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    waves = engines[0].waves + engines[1].waves
    for i, w in enumerate(waves):
        print(f"wave {i}: {w.batch} requests, prompt {w.prompt_len} tokens "
              f"padded: prefill {w.prefill_s * 1e3:.1f} ms "
              f"({w.batch * w.prompt_len / w.prefill_s:.0f} prompt tokens/s)"
              f"; {w.decode_steps} decode steps, "
              f"{w.decode_s * 1e3 / max(w.decode_steps, 1):.2f} ms per step "
              f"({w.batch} tokens per step) ({smi})")
    n_gen = sum(len(v) for v in out.values())
    print(f"served {len(reqs) + n_long} requests "
          f"({int(lengths.sum()) + n_long * s_long} prompt tokens, {n_gen} "
          f"generated) in {wall:.2f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches} (the dense "
          f"path runs plain PyTorch: the reference has no attention kernel)")
    if launches:
        raise AssertionError(f"gemma launches {launches}")
    if not finite or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite hidden states or logits")
    for r in reqs + long_reqs:
        seq = out[r.rid]
        if not (1 <= len(seq) <= MAMBA_NEW and (seq >= 0).all()
                and (seq < cfg.vocab).all()):
            raise AssertionError(f"request {r.rid}: bad output {seq}")

    for label, wave, max_len, faults in (
            ("wave 0", reqs[:MAMBA_SLOTS], None, False),
            ("the long wave", long_reqs, max_long, True)):
        toks = _padded(wave, "cuda")
        nxt = torch.from_numpy(rng.integers(
            3, cfg.vocab, (len(wave), DECODE_STEPS))).to(toks.device)
        errs, same, flips, decisive = dense_decode_vs_full(
            model, params, toks, nxt,
            max_len or toks.shape[1] + DECODE_STEPS, faults)
        print(f"prefill + {DECODE_STEPS} decode steps vs full forward, "
              f"{label} ({len(wave)} x {toks.shape[1]} + {DECODE_STEPS} "
              f"tokens), max |dlogit| in units of the row RMS (limit "
              f"{TOL_DENSE_FAULT}; the faults on the first step): "
              + ", ".join(f"{k} {v:.5f}" for k, v in errs.items())
              + f"; logits equal the clean decode's bit for bit: "
              + ", ".join(f"{k} {v}" for k, v in same.items())
              + f"; {flips} argmax flips among {decisive} rows of margin > "
                f"{MARGIN_DEEP}")
        if flips:
            raise AssertionError(f"{label}: decode through the cache flips "
                                 f"a decisive argmax of the full forward")
        if errs["clean"] > TOL_DENSE_FAULT or not same["clean, decoded twice"]:
            raise AssertionError(f"{label}: the clean decode disagrees with "
                                 f"the full forward or with itself")
        if faults:
            (out_w, in_w, glob) = list(errs)[1:]
            if not same[out_w]:
                raise AssertionError("a value outside the local window "
                                     "changed the logits")
            if not (errs[in_w] > TOL_DENSE_FAULT
                    and errs[glob] > TOL_DENSE_FAULT):
                raise AssertionError(f"the limit {TOL_DENSE_FAULT} does not "
                                     f"see the planted in-window faults")
        del toks

    profile_decode(model, params, {"tokens": _padded(reqs[:MAMBA_SLOTS],
                                                     "cuda")}, 1024, "gemma2")
    return launches, model, params


# ---------------------------------------------------------------------------
# Main paths 7-10: the rest of the model zoo at full width -- MoE
# (deepseek-moe-16b, one arctic-480b layer), Qwen2-VL's M-RoPE and vision
# stub, RecurrentGemma on ring KV caches, Whisper.
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("deepseek-moe-16b", "arctic-480b", "qwen2-vl-7b",
             "recurrentgemma-9b", "whisper-large-v3")
MOE_ARCH, ARCTIC_ARCH, VLM_ARCH, RG_ARCH, WHISPER_ARCH = ZOO_ARCHS
MIN_DECISIVE = 5                  # rows the flip rule must check
MOE_EP = 8                        # moe_layer_bucket's ranks
VLM_PROMPT = 556                  # main path 6's wave 0 length
RG_PROMPT, RG_STEPS = 2040, 16    # below the 2,048 window; wraps at step 9
WHISPER_PROMPT = 440              # + 8 steps = Whisper's 448 positions
# RecurrentGemma's ring: a value planted in super-block 0's K and V at the
# slot the next step overwrites must leave that step's logits bit for bit
# (cache_update writes before decode_attention reads); at the newest slot
# it must move them (max |dlogit| against the full forward, in units of
# its row RMS) past TOL_RING_FAULT, which the clean first step stays under.
TOL_RING_FAULT = 0.5


def close_tree(got, want, what: str, tol: float = TOL_MODEL) -> None:
    """Every tensor of a card tree against the CPU tree's at ``tol``."""
    if isinstance(want, dict):
        for k in want:
            close_tree(got[k], want[k], f"{what}.{k}", tol)
    elif isinstance(want, tuple):
        names = getattr(want, "_fields", None) or range(len(want))
        for name, g, w in zip(names, got, want):
            close_tree(g, w, f"{what}.{name}", tol)
    else:
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{what}: {m}")


@contextlib.contextmanager
def head_inputs():
    """Collect the hidden states that the LM head
    (``models/transformer.py:logits_fn``, where every family's decode
    ends) is called with."""
    from repro_torch.models import transformer
    seen = []
    head = transformer.logits_fn

    def spy(params, hidden, cfg, rt=None):
        seen.append(hidden)
        return head(params, hidden, cfg, rt)

    with mock.patch.object(transformer, "logits_fn", spy):
        yield seen


@contextlib.contextmanager
def moe_stats():
    """Collect (tokens, MoEStats) of every ``moe_layer_local`` call (each
    MoE layer of a forward, prefill or decode step), device tensors."""
    from repro_torch.models import moe
    seen = []
    layer = moe.moe_layer_local

    def spy(x, *args, **kw):
        y, stats = layer(x, *args, **kw)
        seen.append((x.shape[0], stats))
        return y, stats

    with mock.patch.object(moe, "moe_layer_local", spy):
        yield seen


def vlm_positions3(B: int, S: int, vision: int, device, grid: bool):
    """Qwen2-VL's (3, B, S) position ids: with ``grid``, the vision tokens
    on a square grid at time 0 (height, width) and the text after them on
    all three axes from the grid's side on; else the broadcast arange (where
    M-RoPE is RoPE)."""
    ar = torch.arange(S, device=device)
    if not grid:
        return ar.expand(3, B, S)
    side = int(round(vision ** 0.5))
    img = torch.arange(vision, device=device)
    text = side + torch.arange(S - vision, device=device)
    rows = [torch.cat([torch.zeros_like(img), text]),
            torch.cat([img // side, text]), torch.cat([img % side, text])]
    return torch.stack(rows)[:, None, :].expand(3, B, S)


def zoo_extras(cfg, B: int, S: int, gen, device, grid: bool = True) -> dict:
    """The batch extras a family reads, drawn from ``gen`` on the CPU:
    Qwen2-VL's vision embeddings (B, vision_tokens, d) bf16 and positions3,
    Whisper's frames (B, enc_ctx, d); none for the others."""
    if cfg.family == "vlm":
        ve = torch.randn((B, cfg.vision_tokens, cfg.d_model), generator=gen)
        return {"vision_embeds": ve.to(device, torch.bfloat16),
                "positions3": vlm_positions3(B, S, cfg.vision_tokens,
                                             device, grid)}
    if cfg.family == "audio":
        return {"enc_frames": torch.randn((B, cfg.enc_ctx, cfg.d_model),
                                          generator=gen).to(device)}
    return {}


def check_zoo_small():
    """The rest of the zoo reduced (deepseek-moe-16b, arctic-480b,
    qwen2-vl-7b with vision embeds and grid positions3, recurrentgemma-9b
    on rings of 16 with a prompt past them, whisper-large-v3), on the card
    against the same models on the CPU: hidden states, prefill (hidden and
    every cache field) and one decode step (the LM head's input and every
    cache field; the logits of the card's head on the CPU's hidden states)
    at the model tolerance 5e-2; no hand-written kernel runs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    rng = np.random.default_rng(4)
    dispatch.reset_launches()
    for arch in ZOO_ARCHS:
        cfg = reduced(get_config(arch))
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        params["embed"] = params["embed"] * 0.25
        card = tree_to(params, "cuda")
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
        batch = {"tokens": tokens, **zoo_extras(
            cfg, 2, 40, torch.Generator().manual_seed(5), "cpu")}
        on_card = tree_to(batch, "cuda")
        nxt = tokens[:, :1]
        close_tree(model.hidden(card, on_card)[0],
                   model.hidden(params, batch)[0], f"{arch} hidden")
        h_gpu, c_gpu = model.prefill(card, on_card, model.init_caches(
            2, 48, device="cuda"))
        h_cpu, c_cpu = model.prefill(params, batch, model.init_caches(
            2, 48, device="cpu"))
        close_tree(h_gpu, h_cpu, f"{arch} prefill hidden")
        close_tree(c_gpu, c_cpu, f"{arch} prefill caches")
        with head_inputs() as seen:
            _, c_gpu = model.decode(card, c_gpu, nxt.cuda())
            l_cpu, c_cpu = model.decode(params, c_cpu, nxt)
        close_tree(seen[0], seen[1], f"{arch} decode hidden")
        close_tree(model.logits(card, seen[1].cuda()), l_cpu,
                   f"{arch} decode logits on the CPU's hidden", 1e-2)
        close_tree(c_gpu, c_cpu, f"{arch} decode caches")
    if dispatch.LAUNCHES:
        raise AssertionError(f"zoo small: launches {dispatch.LAUNCHES}")
    print(f"reduced {', '.join(ZOO_ARCHS)}, card vs CPU: hidden, prefill "
          f"(hidden, every cache field), decode (hidden, logits, caches) "
          f"within {TOL_MODEL}; no kernel launched")


def teacher_forced(model, params, batch: dict, nxt, max_len: int,
                   full_extras: dict | None = None):
    """Prefill over ``batch``, then one decode step for each of the (B, n)
    tokens ``nxt`` in turn, and the full forward over the prompt and
    ``nxt`` (with ``full_extras``): (decode logits (B, n, V), full logits
    at the same positions, the prefill's caches)."""
    n = nxt.shape[1]
    toks = batch["tokens"]
    full = {"tokens": torch.cat([toks, nxt], 1), **(full_extras or {})}
    l_full = model.logits(params, model.hidden(params, full)[0][:, -n:, :])
    _, first = model.prefill(params, batch, model.init_caches(
        len(toks), max_len, device=toks.device))
    steps, c = [], first
    for i in range(n):
        logits, c = model.decode(params, c, nxt[:, i:i + 1])
        steps.append(logits)
    return torch.cat(steps, 1), l_full, first


def flip_rule(label: str, l_dec, l_full, smi: str,
              what: str = "") -> list[float]:
    """Main path 6's rule: no argmax flip of the full forward where its
    top-2 margin exceeds MARGIN_DEEP row RMS, among at least MIN_DECISIVE
    such rows; prints max |dlogit| per step in units of the row RMS and
    returns it.  ``what`` names the two sides (default: prefill + decode
    steps vs the full forward)."""
    rms = l_full.pow(2).mean(-1, keepdim=True).sqrt()
    per_step = ((l_dec - l_full).abs() / rms).amax(dim=(0, 2)).tolist()
    top = l_full.topk(2, dim=-1).values
    decisive = (top[..., 0] - top[..., 1]) > MARGIN_DEEP * rms[..., 0]
    flips = int((decisive & (l_dec.argmax(-1) != l_full.argmax(-1))).sum())
    n_dec = int(decisive.sum())
    what = what or (f"prefill + {l_dec.shape[1]} decode steps vs the full "
                    f"forward")
    print(f"{label}: {what}, max |dlogit| per step in units of the row RMS: "
          + ", ".join(f"{v:.5f}" for v in per_step)
          + f"; {flips} argmax flips among {n_dec} of {decisive.numel()} "
            f"rows of margin > {MARGIN_DEEP} ({smi})")
    if flips:
        raise AssertionError(f"{label}: decode through the cache flips a "
                             f"decisive argmax of the full forward")
    if n_dec < MIN_DECISIVE:
        raise AssertionError(f"{label}: {n_dec} decisive rows, fewer than "
                             f"{MIN_DECISIVE}: the flip rule checks nothing")
    return per_step


def timed_s(fn):
    """(result, host seconds) of ``fn``, synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def load_model(arch: str, smi: str, scale_embed: bool = False, **edit):
    """A full-width model of the zoo with random bf16 weights from seed 0
    on the card (``edit``: config fields replaced, e.g. a cut depth);
    ``scale_embed``: a tied embedding at std d_model^-0.5, as main path 6
    scales it, so that logits have unit RMS and the flip rule has decisive
    rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.modules import param_bytes, param_count
    cfg = dataclasses.replace(get_config(arch), **edit)
    model = build(cfg)
    params, s = timed_s(lambda: model.init(
        torch.Generator().manual_seed(0), param_dtype=torch.bfloat16,
        device="cuda"))
    if scale_embed:
        params["embed"] = params["embed"] * cfg.d_model ** -0.5
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}"
          + (f", edited {edit}" if edit else "")
          + f"; {param_count(model.specs()) / 1e9:.3f} B parameters, "
            f"{param_bytes(model.specs(), torch.bfloat16) / 1e9:.2f} GB in "
            f"bf16, drawn from seed 0 on the card in {s:.2f} s"
          + (", the tied embedding scaled by d_model^-0.5" if scale_embed
             else "") + f" ({smi})")
    return model, params


def serve_timed(model, params, reqs, scfg, smi: str, label: str):
    """Serve ``reqs`` through an engine that checks every prefill hidden
    and decode logit for finiteness on the device, and every output for
    range; print the waves' timings and the peak device memory.  Returns
    the kernel launches (which must be none) and the engine."""
    from repro_torch.kernels import dispatch
    from repro_torch.serve.engine import Engine
    finite = []

    def prefill(p, batch, caches, rt=None):
        h, caches = model.prefill(p, batch, caches, rt)
        finite.append(torch.isfinite(h).all())
        return h, caches

    def decode(p, caches, tokens, rt=None):
        logits, caches = model.decode(p, caches, tokens, rt)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    checked = dataclasses.replace(model, prefill=prefill, decode=decode)
    eng = Engine(checked, scfg)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    out, wall = timed_s(lambda: eng.generate_batch(params, reqs))
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, w in enumerate(eng.waves):
        print(f"{label} wave {i}: {w.batch} requests, prompt "
              f"{w.prompt_len} tokens padded: prefill "
              f"{w.prefill_s * 1e3:.1f} ms "
              f"({w.batch * w.prompt_len / w.prefill_s:.0f} prompt "
              f"tokens/s); {w.decode_steps} decode steps, "
              f"{w.decode_s * 1e3 / max(w.decode_steps, 1):.2f} ms per step "
              f"({w.batch} tokens per step) ({smi})")
    n_gen = sum(len(v) for v in out.values())
    print(f"{label}: served {len(reqs)} requests "
          f"({sum(len(r.prompt) for r in reqs)} prompt tokens, {n_gen} "
          f"generated) in {wall:.2f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}")
    if launches:
        raise AssertionError(f"{label}: launches {launches}")
    if not finite or not bool(torch.stack(finite).all()):
        raise AssertionError(f"{label}: non-finite hidden states or logits")
    vocab = model.cfg.vocab
    for r in reqs:
        seq = out[r.rid]
        if not (1 <= len(seq) <= scfg.max_new_tokens and (seq >= 0).all()
                and (seq < vocab).all()):
            raise AssertionError(f"{label}: request {r.rid}: bad output "
                                 f"{seq}")
    return launches, eng


def _prompts(rng, vocab, n, lengths=MAMBA_PROMPTS):
    from repro_torch.serve.engine import Request
    return [Request(i, rng.integers(3, vocab, int(s)).astype(np.int32))
            for i, s in enumerate(rng.integers(*lengths, n))]


def warm_up(model, params, extras: dict | None = None):
    """One short request (library handles, allocator) before timing."""
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    prompt = np.arange(3, 43, dtype=np.int32)
    Engine(model, ServeConfig(slots=1, max_len=64, max_new_tokens=2)) \
        .generate_batch(params, [Request(-1, prompt, extras=extras)])


def check_moe_bucket(cfg, params, x, smi: str):
    """``moe_layer_bucket`` with EP MOE_EP as a leading dimension against
    ``moe_layer_local`` on MoE layer 0's weights in f32, on ``x`` (T, d)
    f32, at the reference's 2e-4 (``tests/test_multidevice.py:135``), the
    capacity factor E / k so that neither drops an assignment."""
    from repro_torch.models import moe as M
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                              / cfg.moe.top_k)
    p = {k: params["blocks"][k][0].float()
         for k in ("router", "w_gate", "w_up", "w_down")}
    T, d = x.shape
    (y_loc, st_loc), t_loc = timed_s(
        lambda: M.moe_layer_local(x, p, moe, act=cfg.act))
    e_loc = moe.n_experts // MOE_EP
    ranked = {k: v.view(MOE_EP, e_loc, *v.shape[1:]) for k, v in p.items()
              if k != "router"}
    (y_b, st_b), t_b = timed_s(lambda: M.moe_layer_bucket(
        x.view(MOE_EP, T // MOE_EP, d), {"router": p["router"], **ranked},
        moe, act=cfg.act))
    dropped = (float(st_loc.dropped), float(st_b.dropped.max()))
    err = max_abs_err([(y_b.reshape(T, d), y_loc)])
    print(f"moe_layer_bucket (EP {MOE_EP} x {e_loc} experts, {T // MOE_EP} "
          f"tokens a rank) vs moe_layer_local, layer 0 of {cfg.name} in "
          f"f32 on {T} prefill hidden states: max |dy| {err:.3e} (|y| max "
          f"{float(y_loc.abs().max()):.3f}), dropped {dropped}; host "
          f"{t_b * 1e3:.1f} / {t_loc * 1e3:.1f} ms ({smi})")
    torch.testing.assert_close(y_b.reshape(T, d), y_loc, rtol=2e-4,
                               atol=2e-4, msg=lambda m: f"bucket: {m}")
    if dropped != (0.0, 0.0):
        raise AssertionError(f"bucket check dropped {dropped}")


def run_moe_main_path(smi: str):
    """Main path 7: serve deepseek-moe-16b at its published widths (28
    layers, the first dense with d_ff 10,944; 64 experts top-6 of 1,408 and
    2 shared; capacity factor 1.25; 16.38 B parameters) on the card: main
    path 2's 8 requests through 4 slots, 16 new tokens each, each prefill
    wave's dropped fraction printed.  Prefill + 8 teacher-forced decode
    steps against the full forward (flip rule) at a capacity factor of
    E / k, where nothing can drop (asserted); moe_layer_bucket at EP 8
    against moe_layer_local on the prefill wave's hidden states; a
    torch.profiler pass."""
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeConfig
    model, params = load_model(MOE_ARCH, smi)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    reqs = _prompts(rng, cfg.vocab, MAMBA_REQUESTS)
    warm_up(model, params)
    with moe_stats() as seen:
        launches, eng = serve_timed(
            model, params, reqs, ServeConfig(slots=MAMBA_SLOTS, max_len=1024,
                                             max_new_tokens=MAMBA_NEW),
            smi, cfg.name)
    n_moe = cfg.n_layers - cfg.moe.first_dense
    prefill_calls = [st.dropped for t, st in seen if t > MAMBA_SLOTS]
    for i, w in enumerate(eng.waves):
        d = torch.stack(prefill_calls[i * n_moe:(i + 1) * n_moe]).cpu()
        print(f"wave {i} prefill ({w.batch * w.prompt_len} tokens, capacity "
              f"factor {cfg.moe.capacity_factor}): dropped fraction over "
              f"{n_moe} MoE layers mean {float(d.mean()):.5f}, max "
              f"{float(d.max()):.5f}")
    decode_drop = max(float(st.dropped) for t, st in seen
                      if t <= MAMBA_SLOTS)
    print(f"decode steps: max dropped fraction {decode_drop}")
    del seen, prefill_calls

    ample_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    ample = build(ample_cfg)
    toks = _padded(reqs[:MAMBA_SLOTS], "cuda")
    nxt = torch.from_numpy(rng.integers(3, cfg.vocab, (MAMBA_SLOTS,
                                                       DECODE_STEPS))).cuda()
    with moe_stats() as seen:
        l_dec, l_full, first = teacher_forced(
            ample, params, {"tokens": toks}, nxt,
            toks.shape[1] + DECODE_STEPS)
    dropped = max(float(st.dropped) for _, st in seen)
    print(f"teacher-forced check at capacity factor "
          f"{ample_cfg.moe.capacity_factor:.3f}: {len(seen)} MoE calls, max "
          f"dropped fraction {dropped}")
    if dropped != 0.0:
        raise AssertionError("the check's MoE layers dropped assignments")
    flip_rule(f"{cfg.name} wave 0 ({MAMBA_SLOTS} x {toks.shape[1]} "
              f"tokens)", l_dec, l_full, smi)
    del l_dec, l_full, first, seen
    h, _ = model.prefill(params, {"tokens": toks}, model.init_caches(
        MAMBA_SLOTS, toks.shape[1], device="cuda"))
    check_moe_bucket(cfg, params, h.float().reshape(-1, cfg.d_model), smi)
    del h
    profile_decode(model, params, {"tokens": toks}, 1024, cfg.name)
    return launches, model, params


def run_arctic_layer(smi: str):
    """Main path 7, second part: one arctic-480b layer at full width
    (n_layers 1 of 35: 128 experts top-2 of 4,864, the parallel dense MLP
    of 4,864; 14.07 B parameters): the hidden states of main path 6's
    wave 0 tokens (4 x 556), prefill + 8 teacher-forced decode steps
    against the full forward at a capacity factor of E / k (nothing
    dropped, asserted; flip rule), and at the published 1.25 the prefill's
    dropped fraction and the prefill and decode times."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    model, params = load_model(ARCTIC_ARCH, smi, n_layers=1)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    toks = _padded(_prompts(rng, cfg.vocab, MAMBA_REQUESTS)[:MAMBA_SLOTS],
                   "cuda")
    nxt = torch.from_numpy(rng.integers(3, cfg.vocab, (MAMBA_SLOTS,
                                                       DECODE_STEPS))).cuda()
    batch = {"tokens": toks}
    warm_up(model, params)
    dispatch.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with moe_stats() as seen:
        (h, _), t_hidden = timed_s(lambda: model.hidden(params, batch))
        (_, caches), t_pre = timed_s(lambda: model.prefill(
            params, batch, model.init_caches(MAMBA_SLOTS, 1024,
                                             device="cuda")))

        def steps():
            c = caches
            for i in range(DECODE_STEPS):
                _, c = model.decode(params, c, nxt[:, i:i + 1])
        _, t_dec = timed_s(steps)
    if not bool(torch.isfinite(h).all()):
        raise AssertionError("arctic: non-finite hidden states")
    S = toks.shape[1]
    print(f"{cfg.name} (1 layer): hidden {t_hidden * 1e3:.1f} ms, prefill "
          f"{t_pre * 1e3:.1f} ms for {MAMBA_SLOTS} x {S} tokens "
          f"({MAMBA_SLOTS * S / t_pre:.0f} prompt tokens/s), decode "
          f"{t_dec * 1e3 / DECODE_STEPS:.2f} ms per step; dropped fraction "
          f"at factor {cfg.moe.capacity_factor}: hidden "
          f"{float(seen[0][1].dropped):.5f}, prefill "
          f"{float(seen[1][1].dropped):.5f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{dict(dispatch.LAUNCHES)} ({smi})")
    launches = dict(dispatch.LAUNCHES)
    if launches:
        raise AssertionError(f"arctic launches {launches}")
    del h, caches, seen
    ample = build(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)))
    with moe_stats() as seen:
        l_dec, l_full, _ = teacher_forced(ample, params, batch, nxt,
                                          S + DECODE_STEPS)
    dropped = max(float(st.dropped) for _, st in seen)
    if dropped != 0.0:
        raise AssertionError("arctic's check dropped assignments")
    flip_rule(f"{cfg.name} (1 layer), wave 0 ({MAMBA_SLOTS} x {S} tokens, "
              f"dropped 0)", l_dec, l_full, smi)
    del l_dec, l_full
    profile_decode(model, params, batch, 1024, f"{cfg.name} (1 layer)")
    return launches


def run_vlm_main_path(smi: str):
    """Main path 8: qwen2-vl-7b at its published widths (28 layers, d_model
    3584, 28 / 4 heads of 128 with QKV bias, M-RoPE sections 16 / 24 / 24,
    256 vision tokens; 7.62 B parameters): a prefill of 4 x 556 tokens with
    vision embeddings (4, 256, 3584) and grid positions3 through the model
    API; prefill + 8 teacher-forced decode steps against the full forward
    at positions3 = the broadcast arange (M-RoPE = RoPE there, so decode's
    plain RoPE continues it), flip rule; the engine at 1 slot with each
    request's own extras; torch.profiler passes."""
    from repro_torch.kernels import dispatch
    from repro_torch.serve.engine import Request, ServeConfig
    model, params = load_model(VLM_ARCH, smi)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(6)
    rng = np.random.default_rng(0)
    reqs = _prompts(rng, cfg.vocab, MAMBA_SLOTS)
    reqs = [Request(r.rid, r.prompt, extras=zoo_extras(
        cfg, 1, len(r.prompt), gen, "cuda")) for r in reqs]
    warm_up(model, params)
    launches, _ = serve_timed(
        model, params, reqs, ServeConfig(slots=1, max_len=1024,
                                         max_new_tokens=MAMBA_NEW),
        smi, f"{cfg.name} (1 slot, per-request extras)")

    toks = torch.from_numpy(rng.integers(3, cfg.vocab, (MAMBA_SLOTS,
                                                        VLM_PROMPT))).cuda()
    ve = zoo_extras(cfg, MAMBA_SLOTS, VLM_PROMPT, gen, "cuda")
    dispatch.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (h, _), t_pre = timed_s(lambda: model.prefill(
        params, {"tokens": toks, **ve}, model.init_caches(
            MAMBA_SLOTS, 1024, device="cuda")))
    print(f"{cfg.name}: prefill of {MAMBA_SLOTS} x {VLM_PROMPT} tokens "
          f"(256 vision embeddings each, grid positions3) "
          f"{t_pre * 1e3:.1f} ms ({MAMBA_SLOTS * VLM_PROMPT / t_pre:.0f} "
          f"prompt tokens/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{dict(dispatch.LAUNCHES)} ({smi})")
    if dispatch.LAUNCHES or not bool(torch.isfinite(h).all()):
        raise AssertionError("vlm prefill: launches or non-finite")
    del h
    nxt = torch.from_numpy(rng.integers(3, cfg.vocab, (MAMBA_SLOTS,
                                                       DECODE_STEPS))).cuda()
    S = VLM_PROMPT
    arange3 = lambda n: vlm_positions3(MAMBA_SLOTS, n, cfg.vision_tokens,
                                       "cuda", grid=False)
    l_dec, l_full, _ = teacher_forced(
        model, params, {"tokens": toks, "vision_embeds": ve["vision_embeds"],
                        "positions3": arange3(S)}, nxt, S + DECODE_STEPS,
        {"vision_embeds": ve["vision_embeds"],
         "positions3": arange3(S + DECODE_STEPS)})
    flip_rule(f"{cfg.name} ({MAMBA_SLOTS} x {S} tokens, vision embeddings, "
              f"positions3 = arange)", l_dec, l_full, smi)
    del l_dec, l_full
    profile_decode(model, params, {"tokens": toks, **ve}, 1024, cfg.name)
    return launches


def run_rg_main_path(smi: str):
    """Main path 9: recurrentgemma-9b at its published widths (38 layers:
    12 (RG-LRU, RG-LRU, local attention) super-blocks + 2 RG-LRU layers;
    d_model 4096, lru width 4096, 16 heads x 256 on 1 KV head, window
    2,048; 9.40 B parameters), its attention on ring KV caches of 2,048
    slots: 2 requests of 2,040 tokens, 16 new tokens each (the ring wraps
    at decode step 9); the 16 decode steps teacher-forced against the full
    forward over 2,056 tokens (flip rule); a value planted at the slot the
    next step overwrites leaves its logits bit for bit, at the newest
    slot it moves them past TOL_RING_FAULT; torch.profiler passes."""
    from repro_torch.serve.engine import ServeConfig
    model, params = load_model(RG_ARCH, smi, scale_embed=True)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    reqs = _prompts(rng, cfg.vocab, 2, (RG_PROMPT, RG_PROMPT + 1))
    warm_up(model, params)
    launches, _ = serve_timed(
        model, params, reqs, ServeConfig(slots=2, max_len=RG_PROMPT,
                                         max_new_tokens=RG_STEPS + 1),
        smi, cfg.name)
    toks = _padded(reqs, "cuda")
    nxt = torch.from_numpy(rng.integers(3, cfg.vocab,
                                        (2, RG_STEPS))).cuda()
    l_dec, l_full, first = teacher_forced(model, params, {"tokens": toks},
                                          nxt, 0)
    per_step = flip_rule(f"{cfg.name} (2 x {RG_PROMPT} tokens, ring of "
                         f"{cfg.sliding_window}; steps 1-8 before the wrap, "
                         f"steps 1-7 with unwritten slots)", l_dec, l_full,
                         smi)
    rms = l_full[:, :1].pow(2).mean(-1, keepdim=True).sqrt()
    T = cfg.sliding_window
    readings, same = {"clean": per_step[0]}, {}
    for name, slot in ((f"next overwrite, slot {RG_PROMPT % T}",
                        RG_PROMPT % T),
                       (f"newest, slot {(RG_PROMPT - 1) % T}",
                        (RG_PROMPT - 1) % T)):
        k, v = first.attn.k.clone(), first.attn.v.clone()
        k[0, :, slot] = CACHE_VALUE
        v[0, :, slot] = CACHE_VALUE
        l_f, _ = model.decode(params, first._replace(
            attn=first.attn._replace(k=k, v=v)), nxt[:, :1])
        readings[name] = float(((l_f - l_full[:, :1]).abs() / rms).max())
        same[name] = torch.equal(l_f, l_dec[:, :1])
        del k, v, l_f
    nxt_name, new_name = list(same)
    print(f"ring faults in super-block 0, first decode step (limit "
          f"{TOL_RING_FAULT}): "
          + ", ".join(f"{k} {v:.5f}" for k, v in readings.items())
          + "; logits equal the clean decode's bit for bit: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    if not same[nxt_name]:
        raise AssertionError("a value at the slot the next step overwrites "
                             "changed its logits")
    if not (readings[new_name] > TOL_RING_FAULT >= readings["clean"]):
        raise AssertionError(f"the limit {TOL_RING_FAULT} does not split the "
                             f"clean step from the newest-slot fault")
    del l_dec, l_full, first
    profile_decode(model, params, {"tokens": toks}, 0, cfg.name)
    return launches


def run_whisper_main_path(smi: str):
    """Main path 10: whisper-large-v3 at its published widths (32 + 32
    layers, d_model 1280, 20 heads x 64, d_ff 5120, vocab 51,866; 1.54 B
    parameters) on 1,500 encoder frames: batch 2 through the model API
    (encode, fill_cross_cache, prefill of 440 tokens, 8 decode steps)
    against the full forward (flip rule); the engine at 1 slot, each
    request with its own (1, 1500, 1280) frames as the reference's launcher
    makes them; torch.profiler passes."""
    from repro_torch.models import encdec as E
    from repro_torch.serve.engine import Request, ServeConfig
    # the tied embedding at the init's std: with no softcap its logits do
    # not saturate, and scaled by d_model^-0.5 (Whisper has no sqrt(d)
    # input scale, unlike gemma and RecurrentGemma) they flatten: 2 of 16
    # rows decisive on the H100 (PERF.md §6)
    model, params = load_model(WHISPER_ARCH, smi)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(0)
    reqs = [Request(r.rid, r.prompt, extras=zoo_extras(cfg, 1, 0, gen,
                                                       "cuda"))
            for r in _prompts(rng, cfg.vocab, MAMBA_SLOTS, (4, 12))]
    warm_up(model, params, zoo_extras(cfg, 1, 0, gen, "cuda"))
    launches, _ = serve_timed(
        model, params, reqs, ServeConfig(slots=1, max_len=64,
                                         max_new_tokens=MAMBA_NEW),
        smi, f"{cfg.name} (1 slot, per-request frames)")
    frames = zoo_extras(cfg, 2, 0, gen, "cuda")
    enc, t_enc = timed_s(lambda: E.encode(params, frames["enc_frames"], cfg))
    print(f"{cfg.name}: encode of 2 x {cfg.enc_ctx} frames "
          f"{t_enc * 1e3:.1f} ms ({smi})")
    del enc
    toks = torch.from_numpy(rng.integers(3, cfg.vocab,
                                         (2, WHISPER_PROMPT))).cuda()
    nxt = torch.from_numpy(rng.integers(3, cfg.vocab,
                                        (2, DECODE_STEPS))).cuda()
    l_dec, l_full, _ = teacher_forced(
        model, params, {"tokens": toks, **frames}, nxt,
        WHISPER_PROMPT + DECODE_STEPS, frames)
    flip_rule(f"{cfg.name} (2 x {WHISPER_PROMPT} tokens on {cfg.enc_ctx} "
              f"frames)", l_dec, l_full, smi)
    del l_dec, l_full
    profile_decode(model, params, {"tokens": toks, **frames},
                   WHISPER_PROMPT + 8, cfg.name)
    return launches


# ---------------------------------------------------------------------------
# The training path (item 12 parts 5-6): kernel E under autograd, the
# reduced zoo trained card vs CPU, the trainer's crash and restart on the
# card, minicpm-2b and mamba2-2.7b trained at their published widths.
# ---------------------------------------------------------------------------

E_GRAD_CHUNKS = 8                 # main path 12's chunks per sequence
TOL_TRAIN_METRIC = 1e-2           # loss, nll, z, aux, grad_norm, relative
TOL_GRAD = 5e-2                   # rms(card - CPU) per leaf / rms(CPU)
TOL_REMAT = 1e-6                  # remat on vs off, where atomics reorder
TOL_OPT = 1e-6                    # the optimizer on the same gradients
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
MINICPM_ARCH = "minicpm-2b"
# sequences, tokens each, steps, peak lr: MiniCPM's 4,096-token context
# (arXiv:2404.06395) at the launcher's lr; Mamba-2's 2,048-token
# pretraining context (arXiv:2405.21060) at 1e-4: its tied embedding at
# the reference's init (std 1, no input scale) gives logits of std
# sqrt(2560) ~ 51 (loss ~300 at step 1), and at 1e-3 the third step
# overshot (a probe on the H100 read 314, 263, 491, 384)
MINICPM_TRAIN = (2, 4096, 4, 1e-3)   # 4 steps: the time limit
MAMBA_TRAIN = (2, 2048, 4, 1e-4)


def check_ssd_chunk_grad(gen, bh, chunk, head_dim, d_state, bg):
    """Kernel E under autograd (``ssd_chunk_grad``) at main path 12's shape:
    ``E_GRAD_CHUNKS`` chunks of bh pairs chained through s_prev, bf16 x, B
    and C, the loss sum(y_i * w_i) + sum(s * w_s) backwards, against
    autograd of the plain loop on the same inputs on the card: the outputs
    and the gradients of all six inputs at E's rtol/atol 2e-4 (the bf16
    gradients of x, B and C plus one bf16 rounding: a chunk's s_prev
    differs by the forward's 2e-4 and moves the C, dt and A gradients of
    the next).  The forward launches the tensor-core kernel once a chunk,
    the backward none.  Returns (launches, max abs err, ms, plain ms)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ssd_chunk as ssd
    chunks = [_ssd_inputs(gen, bh, chunk, head_dim, d_state, torch.bfloat16,
                          bg) for _ in range(E_GRAD_CHUNKS)]
    A, s0 = chunks[0][2], chunks[0][5]
    w_y = [torch.randn((bh, chunk, head_dim), generator=gen, device="cuda")
           for _ in chunks]
    w_s = torch.randn((bh, head_dim, d_state), generator=gen, device="cuda")

    def run(fn):
        leaves = [[t.clone().requires_grad_() for t in (x, dt, B, C)]
                  for x, dt, _, B, C, _ in chunks]
        a, s_in = A.clone().requires_grad_(), s0.clone().requires_grad_()
        s, loss, ys = s_in, 0.0, []
        for (x, dt, B, C), w in zip(leaves, w_y):
            y, s = fn(x, dt, a, B, C, s)
            ys.append(y.detach())
            loss = loss + (y * w).sum()
        (loss + (s * w_s).sum()).backward()
        grads = {f"{n} {i}": t.grad for i, lv in enumerate(leaves)
                 for n, t in zip(("x", "dt", "B", "C"), lv)}
        grads.update(A=a.grad, s_prev=s_in.grad)
        return ys + [s.detach()], grads

    dispatch.reset_launches()
    out, grads = run(ssd.ssd_chunk_grad)
    launches = dict(dispatch.LAUNCHES)
    if launches != {"ssd_chunk": E_GRAD_CHUNKS}:
        raise AssertionError(f"E under autograd: launches {launches}, want "
                             f"{E_GRAD_CHUNKS} of ssd_chunk")
    want_out, want_grads = run(ssd.ssd_chunk_plain)
    for i, (a, b) in enumerate(zip(out, want_out)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"E grad: output {i}: {m}")
    err = max_abs_err(zip(out, want_out))
    for name, g in grads.items():
        w = want_grads[name]
        if g is None or g.dtype != w.dtype or not bool(
                torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            raise AssertionError(f"E grad: d{name} is missing, not finite "
                                 f"or 0")
        a, b = g.float(), w.float()
        limit = 2e-4 + 2e-4 * b.abs()
        if g.dtype == torch.bfloat16:           # + one bf16 ulp
            limit = limit + torch.exp2(torch.floor(torch.log2(
                torch.maximum(a.abs(), b.abs()).clamp(min=1e-30))) - 7)
        if bool(((a - b).abs() > limit).any()):
            raise AssertionError(f"E grad: d{name} differs from the plain "
                                 f"loop's by up to {max_abs_err([(a, b)])}")
        err = max(err, max_abs_err([(a, b)]))

    def timed(fn):
        times = []
        for _ in range(3):
            times.append(timed_s(lambda: run(fn))[1] * 1e3)
        return statistics.median(times)

    ms, plain_ms = timed(ssd.ssd_chunk_grad), timed(ssd.ssd_chunk_plain)
    print(f"ssd_chunk_grad ({E_GRAD_CHUNKS} chunks of {bh} pairs x {chunk} "
          f"x {head_dim} x {d_state}, bf16, chained): outputs and the 6 "
          f"inputs' gradients == autograd of the plain loop within 2e-4 "
          f"(bf16 gradients + one bf16 ulp), max abs err {err:.3e}; "
          f"launches {launches} (forward only: the backward is the plain "
          f"version's vjp); forward + backward {ms:.2f} ms, plain loop "
          f"{plain_ms:.2f} ms (host clock, synchronised)")
    return launches["ssd_chunk"], err, ms, plain_ms


def rms(t: torch.Tensor) -> float:
    return float(t.double().pow(2).mean().sqrt())


def train_leaves(tree) -> list:
    """The tensors of a tree of dicts (sorted keys), lists and (named)
    tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in train_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in train_leaves(v)]
    return [tree]


def _flipped(got: torch.Tensor, want: torch.Tensor, leaf: str) -> set:
    """(layer, expert) of an MoE leaf whose gradient misses TOL_GRAD; the
    router (L, d, E) is read per expert column."""
    if leaf == "router":
        got, want = got.movedim(-1, 1), want.movedim(-1, 1)
    return {(i, e) for i in range(want.shape[0])
            for e in range(want.shape[1])
            if rms(got[i, e] - want[i, e]) > TOL_GRAD * rms(want[i, e])}


def close_grads(got: dict, want: dict, what: str) -> float:
    """Every gradient leaf of the card (``got``) against the CPU's: the RMS
    of the difference within TOL_GRAD of the CPU leaf's RMS; MoE expert
    leaves expert by expert, allowing one routing flip (a top-k margin
    inside the bf16 noise sends a token to another expert: at most 2
    experts of a layer, the same in every expert leaf).  Returns the worst
    relative RMS over the leaves held whole."""
    worst, flips = 0.0, {}
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            worst = max(worst, close_grads(g, w, f"{what}/{k}"))
            continue
        g = g.cpu().float()
        w = w.float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}/{k}: gradient not finite")
        if k in MOE_LEAVES and "router" in want:
            flips[k] = _flipped(g, w, k)
            continue
        rel = rms(g - w) / max(rms(w), 1e-30)
        if rel > TOL_GRAD:
            raise AssertionError(f"{what}/{k}: rms(card - CPU) / rms(CPU) "
                                 f"{rel:.3e} > {TOL_GRAD}")
        worst = max(worst, rel)
    if flips:
        per_layer = {}
        for layer, e in set().union(*flips.values()):
            per_layer.setdefault(layer, set()).add(e)
        if any(len(v) > 2 for v in per_layer.values()) or any(
                flips[k] != flips["w_gate"] for k in ("w_up", "w_down")):
            raise AssertionError(f"{what}: expert gradients differ beyond "
                                 f"one routing flip: {flips}")
        if flips["w_gate"]:
            print(f"{what}: one routing flip moved experts "
                  f"{sorted(flips['w_gate'])}")
    return worst


def _train_batch(cfg, B: int, S: int, step: int, device) -> dict:
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                       global_batch=B), step)
    batch.update(zoo_extras(cfg, B, S, torch.Generator().manual_seed(step),
                            "cpu"))
    return tree_to(batch, device)


def _metrics_close(got: dict, want: dict, what: str, n_tokens: int,
                   moe: bool) -> None:
    for k in ("loss", "nll", "z", "aux", "grad_norm"):
        g, w = float(got[k]), float(want[k])
        # a MoE load-balance term moves by ~2 / tokens with one top-1 flip
        tol = TOL_TRAIN_METRIC * abs(w) + (2.0 / n_tokens if moe and
                                           k == "aux" else 1e-6)
        if not np.isfinite(g) or abs(g - w) > tol:
            raise AssertionError(f"{what}: {k} card {g} vs CPU {w}")


def check_train_small(smi: str):
    """The training path reduced, card against CPU on the same parameters
    (f32, seed 0) and batch (``synthetic_batch``, 2 x 32 tokens, the
    family's extras): one train step of each of the ten architectures
    (loss, nll, z, aux and grad_norm at TOL_TRAIN_METRIC; each gradient
    leaf by ``close_grads``), the reduced Mamba-2's gradients reaching
    in_proj, conv and A_log through kernel E; arctic with Adafactor and a
    bf16 momentum (the optimizer on the CPU's gradients, card vs CPU: params
    and moments at TOL_OPT, the momentum within one bf16 ulp); reduced
    minicpm-2b with per-layer remat on against off on the card; and the
    reference's trainer test on the card (checkpoints under
    ``build/train_ckpt``)."""
    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    B, S = 2, 32
    dispatch.reset_launches()
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        model = build(cfg)
        tcfg = step_lib.TrainConfig()
        if arch == "arctic_480b":
            tcfg = step_lib.TrainConfig(optimizer=opt.OptimizerConfig(
                kind="adafactor", momentum_dtype="bfloat16"))
        grads_fn = step_lib.make_compute_grads(model, tcfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        card = tree_to(params, "cuda")
        batch = _train_batch(cfg, B, S, 0, "cpu")
        g_cpu, m_cpu = grads_fn(params, batch)
        g_gpu, m_gpu = grads_fn(card, tree_to(batch, "cuda"))
        worst = close_grads(g_gpu, g_cpu, f"{arch} gradients")
        if arch == "mamba2_27b":
            for k in ("in_proj", "conv_w", "A_log"):
                if not bool(g_gpu["blocks"][k].abs().max() > 0):
                    raise AssertionError(f"mamba2: no gradient on {k}")
        # the optimizer on each device's own gradients, then on the CPU's
        # gradients on both
        g_same = tree_to(g_cpu, "cuda")
        st_cpu = opt.init_opt(params, tcfg.optimizer)
        st_gpu = opt.init_opt(card, tcfg.optimizer)
        _, st_cpu, om_cpu = opt.apply_opt(g_cpu, st_cpu, params,
                                          tcfg.optimizer)
        om_gpu = {"grad_norm": opt.global_norm(g_gpu)}
        _, st_gpu, _ = opt.apply_opt(g_same, st_gpu, card, tcfg.optimizer)
        _metrics_close({**m_gpu, **om_gpu}, {**m_cpu, **om_cpu}, arch,
                       B * S, cfg.moe is not None)
        opt_err = 0.0
        for a, b in zip(train_leaves([card, st_gpu]),
                        train_leaves([params, st_cpu])):
            a = a.cpu()
            if b.dtype == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    b.float().abs().clamp(min=1e-38))) - 7)
                if bool(((a.float() - b.float()).abs() > ulp).any()):
                    raise AssertionError(f"{arch}: bf16 momentum beyond "
                                         f"one ulp")
                continue
            torch.testing.assert_close(
                a, b, rtol=TOL_OPT, atol=TOL_OPT * float(b.abs().max()),
                msg=lambda m: f"{arch}: optimizer card vs CPU: {m}")
            opt_err = max(opt_err, max_abs_err([(a, b)]))
        print(f"{arch}: loss {float(m_gpu['loss']):.4f} (CPU "
              f"{float(m_cpu['loss']):.4f}), grad_norm "
              f"{float(om_gpu['grad_norm']):.4f} (CPU "
              f"{float(om_cpu['grad_norm']):.4f}); gradients worst "
              f"rms(card - CPU) / rms {worst:.2e}; {tcfg.optimizer.kind} on "
              f"the same gradients max abs err {opt_err:.2e}")
    launches = dict(dispatch.LAUNCHES)
    # the reduced Mamba-2's SSD chunks: 2 layers x 2 chunks of 16, the
    # forward and its per-layer recompute
    if launches != {"ssd_chunk": 8}:
        raise AssertionError(f"train small: launches {launches}, want 8 "
                             f"of ssd_chunk (the reduced Mamba-2)")

    cfg = reduced(get_config(MINICPM_ARCH))
    model = build(cfg)
    card = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = _train_batch(cfg, B, S, 1, "cuda")
    on, m_on = step_lib.make_compute_grads(
        model, step_lib.TrainConfig(remat=True))(card, batch)
    off, m_off = step_lib.make_compute_grads(
        model, step_lib.TrainConfig(remat=False))(card, batch)
    same, worst = 0, 0.0
    for a, b in zip(train_leaves([on, m_on]), train_leaves([off, m_off])):
        if torch.equal(a, b):
            same += 1
            continue
        rel = rms(a - b) / max(rms(b), 1e-30)
        if rel > TOL_REMAT:
            raise AssertionError(f"remat on vs off: rms diff {rel:.3e}")
        worst = max(worst, rel)
    n = len(train_leaves([on, m_on]))
    print(f"{cfg.name} reduced, remat on vs off on the card: {same} of {n} "
          f"gradient leaves and metrics bit for bit, the rest within "
          f"{worst:.2e} of their RMS")
    check_trainer_restart()


def check_trainer_restart():
    """The reference's trainer test (tests/test_train.py) on the card:
    reduced minicpm-2b, 20 steps with checkpoints every 10 (the loss falls),
    a crash injected at step 25 of 40, a restart that resumes at 20 and
    ends at 40; the checkpoint of step 20 restores the state that the first
    run ended with, bit for bit."""
    import shutil
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import Trainer, TrainerConfig
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    model = build(reduced(get_config(MINICPM_ARCH)))
    tcfg = step_lib.TrainConfig(optimizer=opt.OptimizerConfig(
        schedule=opt.ScheduleConfig(kind="wsd", peak_lr=3e-3,
                                    warmup_steps=5, total_steps=40)))
    dcfg = DataConfig(vocab=model.cfg.vocab, seq_len=32, global_batch=4)
    run = lambda **kw: Trainer(model, tcfg, dcfg, TrainerConfig(
        ckpt_dir=str(TRAIN_CKPT), ckpt_every=10, log_every=5, **kw),
        device="cuda")
    tr = run(steps=20)
    state, hist = tr.run(seed=0)
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"trainer: loss did not fall {hist}")
    saved = tr.ckpt.restore(step_lib.abstract_train_state(model, tcfg), 20,
                            device="cuda")
    for a, b in zip(train_leaves(saved), train_leaves(state), strict=True):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("trainer: the checkpoint differs from the "
                                 "state it saved")
    try:
        run(steps=40, fail_at_step=25).run(seed=0)
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    else:
        raise AssertionError("trainer: the injected crash did not raise")
    tr3 = run(steps=40)
    state3, hist3 = tr3.run(seed=0)
    if hist3[0]["step"] != 21 or int(state3["step"]) != 40:
        raise AssertionError(f"trainer: restart at {hist3[0]['step']} "
                             f"ended at {int(state3['step'])}")
    print(f"trainer on the card: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f} over 20 steps; checkpoint 20 == the "
          f"state bit for bit; crash at 25, restart from 20 to 40 (loss "
          f"{hist3[-1]['loss']:.4f}); straggler events "
          f"{tr3.straggler_events}")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)


def lr_formula(sched, step: int) -> float:
    """The WSD schedule in float64 (the check of the f32 one)."""
    warm = min(step / max(sched.warmup_steps, 1), 1.0)
    decay_start = sched.total_steps * (1 - sched.decay_frac)
    t = min(max((step - decay_start)
                / max(sched.total_steps - decay_start, 1), 0.0), 1.0)
    return sched.peak_lr * warm * (1.0 if step < decay_start
                                   else sched.min_ratio ** t)


def run_train_main_path(arch: str, shape, smi: str):
    """Train ``arch`` at its published widths (nothing cut: f32 parameters
    from seed 0, AdamW f32 moments, the WSD schedule with a warmup of 1
    step) as ``launch/train.py`` builds it: ``synthetic_batch`` through
    the prefetcher, ``shape`` = (sequences, tokens each, steps, peak lr),
    every step logged (each reads its metrics, so each ends synchronised),
    no checkpoint (a full-width save is 2.7 B x 4 f32 leaves, 32.7 GB).
    Checks: every step's loss and grad_norm finite, the last loss below
    the first, lr == the schedule's formula at 1e-6.  Prints ms per step
    (CUDA-synchronised, the median of steps 3 to the last), tokens/s, peak
    memory and a torch.profiler pass over one more step.  Returns the
    kernel launches of the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.modules import param_count
    import shutil
    B, S, steps, lr = shape
    cfg = get_config(arch)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)     # nothing to resume
    trainer = build_trainer(cfg, steps=steps, batch=B, seq=S, lr=lr,
                            schedule="wsd", ckpt_dir=str(TRAIN_CKPT),
                            ckpt_every=steps + 1, device="cuda")
    step_fn, step_ms = trainer.train_step, []

    def timed_step(state, batch):
        out, s = timed_s(lambda: step_fn(state, batch))
        step_ms.append(s * 1e3)
        return out

    trainer.train_step = timed_step
    n_params = param_count(trainer.model.specs())
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}; {n_params / 1e9:.3f} B parameters in f32, AdamW "
          f"(f32 moments), WSD lr {lr:g} warmup 1; {B} x {S} tokens a step, "
          f"{steps} steps ({smi})")
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    (state, hist), run_s = timed_s(lambda: trainer.run(seed=0))
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    sched = trainer.tcfg.optimizer.schedule
    for h in hist:
        print(f"  step {h['step']}: loss {h['loss']:.4f} nll {h['nll']:.4f} "
              f"z {h['z']:.2f} grad_norm {h['grad_norm']:.4f} lr "
              f"{h['lr']:.4e} ({step_ms[h['step'] - 1]:.1f} ms)")
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"{cfg.name}: step {h['step']} not finite")
        want = lr_formula(sched, h["step"])
        if abs(h["lr"] - want) > 1e-6 * want:
            raise AssertionError(f"{cfg.name}: lr {h['lr']} at step "
                                 f"{h['step']}, the formula gives {want}")
    if len(hist) != steps or not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"{cfg.name}: the loss did not fall "
                             f"({hist[0]['loss']} -> {hist[-1]['loss']})")
    ms = statistics.median(step_ms[2:])
    print(f"{cfg.name} trained {steps} steps in {run_s:.1f} s (the "
          f"parameters' init included): {ms:.1f} ms a step (median of steps "
          f"3-{steps}, synchronised), {B * S / ms * 1e3:.0f} tokens/s, peak "
          f"{peak:.2f} GiB, launches {launches}; straggler events "
          f"{trainer.straggler_events} ({smi})")
    batch = _train_batch(cfg, B, S, steps, "cuda")
    profile_device(lambda: step_fn(state, batch), f"one {cfg.name} train "
                   f"step ({B} x {S} tokens)", cfg.n_layers, "layer")
    return launches, dict(ms=ms, peak_gib=peak)


def run_minicpm_train(smi: str):
    """Main path 11: minicpm-2b trained at full width.  The dense family
    runs no hand-written kernel: 0 launches."""
    launches, _ = run_train_main_path(MINICPM_ARCH, MINICPM_TRAIN, smi)
    if launches:
        raise AssertionError(f"minicpm-2b training launched {launches}")
    return launches


def run_mamba_train(smi: str):
    """Main path 12: mamba2-2.7b trained at full width.  Kernel E (the
    tensor-core route: the blocks compute in bf16) launches once a chunk
    and layer in the forward and again in the per-layer recompute of the
    backward: 64 x 8 x 2 a step; the FMA route never."""
    from repro_torch.configs import get_config
    cfg = get_config(MAMBA_ARCH)
    B, S, steps, _ = MAMBA_TRAIN
    want = {"ssd_chunk": cfg.n_layers * (S // cfg.ssm.chunk) * 2 * steps}
    launches, _ = run_train_main_path(MAMBA_ARCH, MAMBA_TRAIN, smi)
    if launches != want:
        raise AssertionError(f"mamba2 training launches {launches}, want "
                             f"{want}")
    print(f"kernel E on main path 12: {launches['ssd_chunk']} launches = "
          f"{cfg.n_layers} layers x {S // cfg.ssm.chunk} chunks x 2 "
          f"(forward, per-layer recompute) x {steps} steps")
    return launches


# ---------------------------------------------------------------------------
# Main paths 13-15 and the distributed and dry-run phases: the mesh paths
# of the LM stack on one card, each mesh axis a leading tensor dimension
# (``launch.mesh.Mesh`` is virtual).  Plain PyTorch, as in the reference
# (its split-KV, group-GQA, sharded MoE and int8 all-reduce are jnp
# inside shard_map): no kernel launches on these paths.
# ---------------------------------------------------------------------------

SPLIT_KV = (2, 4400, 16384, 8)    # requests, prompt tokens, cache, shards
TOL_ATTN = 2e-4                   # tests/test_multidevice.py:212
MOE_SHARDED = (4, 560)            # prompts x tokens: 8 divides the sequence
CP_TOKENS = (2, 4096)             # main path 15's batch
# paths 14 and 15: the sharded against the local dispatch, the group
# against the expand route, max |dh| in units of the RMS; the H100 read
# both below 5e-6 (0.00000 at 5 decimals)
TOL_SHARDED = 2e-4
# the distributed phase's trainer check: reduced deepseek-moe-16b, batch x
# sequence, steps; the first loss (a forward) within TOL_MESH_FIRST and
# every loss within TOL_MESH_LOSS of the mesh-free run's, relative (the CPU
# read 0 and 1.7e-4; an exchange without its transpose moved them by
# 5.3e-4 and up to 2.8e-3)
MESH_TRAIN = (4, 32, 4)
TOL_MESH_FIRST = 1e-4
TOL_MESH_LOSS = 1e-3
COMPRESS_PARTIES = 4
A2A_CHUNKS = 4


def _stepped(model, params, caches, nxt, rt):
    """Decode ``nxt`` (B, n) one token at a time from ``caches`` under
    ``rt``: (logits (B, n, V), ms of each step, synchronised)."""
    steps, ms = [], []
    for i in range(nxt.shape[1]):
        (logits, caches), s = timed_s(
            lambda: model.decode(params, caches, nxt[:, i:i + 1], rt))
        steps.append(logits)
        ms.append(s * 1e3)
    del caches
    return torch.cat(steps, 1), ms


def run_gemma_split_kv(model, params, smi: str):
    """Main path 13: gemma2-9b decoding split-KV at full width, main path
    6's model and parameters: ``Engine(rt=Runtime(mesh 1x8,
    split_kv_axis="model"))`` serves 2 requests of 4,400 tokens into
    caches of 16,384 slots (8 shards of 2,048; shards 3-7 hold no valid
    slot, the local layers' 4,096-token window binds), 16 new tokens.
    Checks: 8 teacher-forced steps split against unsplit from the same
    prefill caches (flip rule, max |dlogit| in row-RMS units); one local
    and one global layer's attention split against unsplit in f32 at
    2e-4; ms a step both ways, peak memory; a profile of one step each
    way; 0 launches."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as A
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = model.cfg
    n_req, s_req, max_len, shards = SPLIT_KV
    rt = Runtime(mesh=make_test_mesh(1, shards), split_kv_axis="model")
    rng = np.random.default_rng(13)
    reqs = [Request(i, rng.integers(3, cfg.vocab, s_req).astype(np.int32))
            for i in range(n_req)]
    eng = Engine(model, ServeConfig(slots=n_req, max_len=max_len,
                                    max_new_tokens=MAMBA_NEW), rt=rt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    out, wall = timed_s(lambda: eng.generate_batch(params, reqs))
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    w = eng.waves[0]
    print(f"{cfg.name} split-KV serving: {n_req} x {s_req} tokens into "
          f"caches of {max_len} ({shards} shards of {max_len // shards}), "
          f"prefill {w.prefill_s * 1e3:.1f} ms, {w.decode_steps} decode "
          f"steps {w.decode_s * 1e3 / max(w.decode_steps, 1):.2f} ms a step;"
          f" {wall:.2f} s in all, peak {peak:.2f} GiB, launches {launches} "
          f"({smi})")
    if launches:
        raise AssertionError(f"split-KV serving launched {launches}")
    for r in reqs:
        seq = out[r.rid]
        if not (1 <= len(seq) <= MAMBA_NEW and (seq >= 0).all()
                and (seq < cfg.vocab).all()):
            raise AssertionError(f"request {r.rid}: bad output {seq}")

    toks = _padded(reqs, "cuda")
    nxt = torch.from_numpy(rng.integers(3, cfg.vocab, (n_req,
                                                       DECODE_STEPS))).cuda()
    _, first = model.prefill(params, {"tokens": toks}, model.init_caches(
        n_req, max_len, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    l_split, ms_split = _stepped(model, params, first, nxt, rt)
    peak_split = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    l_plain, ms_plain = _stepped(model, params, first, nxt, None)
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    flip_rule(f"{cfg.name}, {n_req} x {s_req} + {DECODE_STEPS} tokens",
              l_split, l_plain, smi, what=f"{DECODE_STEPS} decode steps "
              f"split-KV ({shards} shards) vs unsplit, from the same caches")
    print(f"decode step at a {max_len}-slot cache: split-KV "
          f"{statistics.median(ms_split):.2f} ms (peak {peak_split:.2f} GiB),"
          f" unsplit {statistics.median(ms_plain):.2f} ms (peak "
          f"{peak_plain:.2f} GiB), medians of {DECODE_STEPS} steps, "
          f"synchronised ({smi})")
    for label, r in (("split-KV", rt), ("unsplit", None)):
        profile_device(lambda: model.decode(params, first, nxt[:, :1], r),
                       f"one {cfg.name} decode step, {label}, {n_req} slots "
                       f"at a {max_len}-slot cache", 1, "step", top=8)

    # one local (0) and one global (1) layer's attention in f32 on the
    # prefill caches: cache_len 4,400 leaves shards 3-7 empty
    gen = torch.Generator(device="cuda").manual_seed(13)
    scale = cfg.query_scale if cfg.query_scale else None
    c = first["blocks"]
    for layer, win in ((0, cfg.sliding_window), (1, 0)):
        k, v = c.k[layer].float(), c.v[layer].float()
        q = torch.randn((n_req, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                        device="cuda")
        cache = A.KVCache(k, v, c.length[layer])
        want = A.decode_attention(q, cache, window=win,
                                  softcap=cfg.attn_softcap, scale=scale)
        got = C.split_kv_decode_attention(
            q, k.unflatten(1, (shards, -1)).movedim(1, 0),
            v.unflatten(1, (shards, -1)).movedim(1, 0), cache.length,
            scale=scale, window=win, softcap=cfg.attn_softcap)
        err = max_abs_err([(got, want)])
        print(f"layer {layer} ({'local, window %d' % win if win else 'global'}"
              f", cache_len {int(cache.length)}): split-KV vs unsplit "
              f"attention in f32, max |d| {err:.3e} (limit {TOL_ATTN})")
        torch.testing.assert_close(got, want, rtol=TOL_ATTN, atol=TOL_ATTN)
    del first, l_split, l_plain
    return launches


@contextlib.contextmanager
def sharded_moe_stats():
    """Collect the pmean'd MoEStats of every ``_moe_bucket_sharded`` call
    and the per-rank ones of every ``moe_layer_bucket`` call."""
    from repro_torch.models import moe, transformer
    pmean, ranks = [], []
    sharded, layer = transformer._moe_bucket_sharded, moe.moe_layer_bucket

    def spy_sharded(*args, **kw):
        y, st = sharded(*args, **kw)
        pmean.append(st)
        return y, st

    def spy_layer(*args, **kw):
        y, st = layer(*args, **kw)
        ranks.append(st)
        return y, st

    with mock.patch.object(transformer, "_moe_bucket_sharded", spy_sharded), \
            mock.patch.object(moe, "moe_layer_bucket", spy_layer):
        yield pmean, ranks


def run_moe_sharded_prefill(model, params, smi: str):
    """Main path 14: deepseek-moe-16b prefill through the sharded bucket
    dispatch at full width (main path 7's model and parameters):
    ``Runtime(mesh 1x8, moe_impl="bucket", seq_axis="model")``, the
    reference's prefill-cell runtime; 4 prompts of 560 tokens, each EP
    rank bucketing its 70-token slice of each sequence for its 8 local
    experts.  At the published capacity factor 1.25 (the timed run): each
    route's dropped fraction (the per-rank capacity counts the rank's own
    tokens, so they differ by design).  At E / k: the hidden states at
    all positions against the local dispatch's, max |dh| within
    ``TOL_SHARDED`` of their RMS, the logits of the last 8 positions
    (flip rule), 0 dropped; the pmean'd and the local stats side by side;
    0 launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.models.transformer import Runtime
    cfg = model.cfg
    B, S = MOE_SHARDED
    rt = Runtime(mesh=make_test_mesh(1, MOE_EP), moe_impl="bucket",
                 seq_axis="model")
    rng = np.random.default_rng(14)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab, (B, S))).cuda()
    batch = {"tokens": toks}
    fresh = lambda: model.init_caches(B, S, device="cuda")
    model.prefill(params, batch, fresh(), rt)           # warm-up
    n_moe = cfg.n_layers - cfg.moe.first_dense
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with sharded_moe_stats() as (pmean, _):
        (h, _), t_b = timed_s(lambda: model.prefill(params, batch, fresh(),
                                                    rt))
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with moe_stats() as local_seen:
        (h_l, _), t_l = timed_s(lambda: model.prefill(params, batch,
                                                      fresh()))
    d_b = torch.stack([st.dropped for st in pmean]).cpu()
    d_l = torch.stack([st.dropped for _, st in local_seen]).cpu()
    print(f"{cfg.name} prefill, {B} x {S} tokens, capacity factor "
          f"{cfg.moe.capacity_factor}: sharded bucket dispatch (EP "
          f"{MOE_EP}, {S // MOE_EP} tokens of each sequence a rank) "
          f"{t_b * 1e3:.1f} ms, peak {peak:.2f} GiB, dropped over {n_moe} "
          f"layers mean {float(d_b.mean()):.5f} max {float(d_b.max()):.5f};"
          f" local dispatch {t_l * 1e3:.1f} ms, dropped mean "
          f"{float(d_l.mean()):.5f} max {float(d_l.max()):.5f}; launches "
          f"{launches} ({smi})")
    if launches:
        raise AssertionError(f"sharded MoE prefill launched {launches}")
    if len(pmean) != n_moe or not torch.isfinite(h).all():
        raise AssertionError(f"{len(pmean)} sharded MoE calls of {n_moe} "
                             f"layers, or non-finite hidden states")
    del h, h_l

    ample = build(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)))
    with sharded_moe_stats() as (pmean, ranks):
        h_b, _ = ample.prefill(params, batch, fresh(), rt)
    with moe_stats() as local_seen:
        h_l, _ = ample.prefill(params, batch, fresh())
    last = slice(S - DECODE_STEPS, S)
    l_b = model.logits(params, h_b[:, last])
    l_l = model.logits(params, h_l[:, last])
    dropped = max(float(st.dropped) for st in pmean)
    dropped_l = max(float(st.dropped) for _, st in local_seen)
    err = float((h_b.float() - h_l.float()).abs().max()) \
        / float(h_l.float().pow(2).mean().sqrt())
    print(f"at capacity factor {ample.cfg.moe.capacity_factor:.3f}: "
          f"dropped {dropped} (sharded), {dropped_l} (local); hidden states "
          f"at all {B} x {S} positions, sharded vs local: max |dh| "
          f"{err:.3e} of the RMS (limit {TOL_SHARDED})")
    if dropped or dropped_l:
        raise AssertionError("the ample capacity dropped assignments")
    if not err <= TOL_SHARDED:
        raise AssertionError(f"sharded vs local dispatch: {err} of the RMS")
    flip_rule(f"{cfg.name} prefill, {B} x {S} tokens", l_b, l_l, smi,
              what=f"the sharded bucket vs the local dispatch at the last "
              f"{DECODE_STEPS} positions")
    for i in sorted({0, n_moe - 1}):
        sb, (_, sl) = pmean[i], local_seen[i]
        print(f"MoE layer {i}: pmean'd stats aux {float(sb.aux_loss):.5f} "
              f"router_z {float(sb.router_z):.4f} | local aux "
              f"{float(sl.aux_loss):.5f} router_z {float(sl.router_z):.4f} "
              f"| per-rank aux {[round(float(a), 4) for a in ranks[i].aux_loss]}")
    del h_b, h_l, l_b, l_l, ample
    return launches


def run_gemma_context_parallel(model, params, smi: str):
    """Main path 15: gemma2-9b's forward on the context-parallel runtime
    at full width (main path 6's model and parameters):
    ``Runtime(mesh 1x8, seq_axis="model")`` takes the group-GQA route (G
    = 2: 16 query heads over 8 KV heads) on 2 x 4,096 tokens, no gradient;
    the hidden states against the expand route's, max difference in units
    of their RMS within ``TOL_SHARDED``; ms and peak GiB both ways; 0
    launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import Runtime
    cfg = model.cfg
    B, S = CP_TOKENS
    rt = Runtime(mesh=make_test_mesh(1, 8), seq_axis="model")
    rng = np.random.default_rng(15)
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab,
                                                     (B, S))).cuda()}
    res = {}
    with torch.no_grad():
        model.hidden(params, {"tokens": batch["tokens"][:, :256]}, rt)
        for label, r in (("group (context-parallel)", rt), ("expand", None)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_launches()
            (h, _), s = timed_s(lambda: model.hidden(params, batch, r))
            res[label] = (h, s * 1e3, torch.cuda.max_memory_allocated()
                          / 2**30, dict(dispatch.LAUNCHES))
    (h_g, ms_g, pk_g, launches), (h_e, ms_e, pk_e, _) = res.values()
    rms = float(h_e.float().pow(2).mean().sqrt())
    err = float((h_g.float() - h_e.float()).abs().max()) / rms
    print(f"{cfg.name} forward, {B} x {S} tokens: group-GQA route "
          f"{ms_g:.1f} ms, peak {pk_g:.2f} GiB; expand route {ms_e:.1f} ms, "
          f"peak {pk_e:.2f} GiB; max |dh| {err:.3e} of the RMS (limit "
          f"{TOL_SHARDED}); launches {launches} ({smi})")
    if launches:
        raise AssertionError(f"the context-parallel forward launched "
                             f"{launches}")
    if not (err <= TOL_SHARDED and torch.isfinite(h_g).all()):
        raise AssertionError(f"group vs expand route: {err} of the RMS")
    return launches


def run_distributed(smi: str):
    """The distributed phase: (1) ``compressed_psum`` over 4 replicated
    parties on a minicpm-2b gradient tree at full width (main path 11's
    model and batch shape), leaf by leaf within the reference test's
    bounds, the int8 payload and scale of 3 leaves == a CPU run bit for
    bit, ms per tree; (2) ``pipelined_all_to_all`` in 4 chunks on the
    exchange path's (src, dst, capacity) payload == one transpose bit for
    bit; (3) ``launch/train.py``'s trainer on the card: reduced
    deepseek-moe-16b with ``--mesh 1x4 --moe-impl bucket`` (the sharded
    dispatch under autograd, each EP rank holding all tokens) against the
    mesh-free run, the first loss within ``TOL_MESH_FIRST`` and every loss
    within ``TOL_MESH_LOSS``, relative; reduced qwen3-32b with ``--mesh
    2x4``, which reads no mesh axis (the batch is only checked to divide
    and placed): the mesh-free losses bit for bit."""
    import shutil
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import aggregator
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compression as Q
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build
    from repro_torch.train import step as step_lib
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(MINICPM_ARCH)
    model = build(cfg)
    B, S, _, _ = MINICPM_TRAIN
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    grads, _ = step_lib.make_compute_grads(model, step_lib.TrainConfig())(
        params, _train_batch(cfg, B, S, 0, "cuda"))
    del params
    ar = Q.make_compressed_allreduce(Mesh((COMPRESS_PARTIES,), ("pod",)),
                                     ("pod",))
    err0 = Q.init_error_feedback(grads)
    ar(grads, err0)
    (mean, err), s = timed_s(lambda: ar(grads, err0))
    worst = (0.0, 0.0)
    flat_g, flat_m, flat_e = (tree_leaves(t) for t in (grads, mean, err))
    for g, m, e in zip(flat_g, flat_m, flat_e):
        scale = float(g.abs().max())
        dm, de = float((m - g).abs().max()), float(e.abs().max())
        if dm > scale / 127 * 1.5 + 1e-6 or de > scale / 127 + 1e-6:
            raise AssertionError(f"compressed all-reduce out of bounds: "
                                 f"{dm}, {de} at scale {scale}")
        worst = max(worst, (dm / (scale / 127 + 1e-30),
                            de / (scale / 127 + 1e-30)))
    n_el = sum(g.numel() for g in flat_g)
    small = sorted(flat_g, key=lambda t: t.numel())[:3]
    for g in small:
        gn = g.expand(COMPRESS_PARTIES, *g.shape)
        en = torch.zeros_like(gn)
        q_d, s_d, _ = Q.quantize(gn, en)
        q_h, s_h, _ = Q.quantize(gn.cpu(), en.cpu())
        if not (torch.equal(q_d.cpu(), q_h) and torch.equal(s_d.cpu(), s_h)):
            raise AssertionError(f"int8 payload of a {tuple(g.shape)} leaf: "
                                 f"card != CPU")
    print(f"compressed_psum over {COMPRESS_PARTIES} replicated parties on "
          f"{cfg.name}'s gradient tree ({len(flat_g)} leaves, "
          f"{n_el / 1e9:.3f} B f32 values, {B} x {S} tokens): {s * 1e3:.1f} "
          f"ms a tree, synchronised; worst |mean - g| {worst[0]:.3f} and "
          f"|err| {worst[1]:.3f} of scale/127 (bounds 1.5 and 1); the int8 "
          f"payload and scales of the leaves "
          f"{[tuple(g.shape) for g in small]} == the CPU's bit for bit "
          f"({smi})")
    del grads, mean, err, err0, flat_g, flat_m, flat_e

    words, tables = exchange_inputs("cuda")
    dest, guid, routed = tables.route(words)
    payload = aggregator.aggregate(torch.where(routed, words, 0), dest, guid,
                                   X_SHARDS, X_CAPACITY, impl="sort").data
    got = C.pipelined_all_to_all(payload, A2A_CHUNKS)
    if not torch.equal(got, payload.transpose(0, 1)):
        raise AssertionError("pipelined all-to-all != one transpose")
    print(f"pipelined_all_to_all in {A2A_CHUNKS} chunks on the exchange "
          f"payload {tuple(payload.shape)} == one transpose bit for bit")

    B_t, S_t, steps = MESH_TRAIN
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch, mesh_spec, impl in (("deepseek_moe_16b", None, "local"),
                                      ("deepseek_moe_16b", "1x4", "bucket"),
                                      ("qwen3_32b", None, "local"),
                                      ("qwen3_32b", "2x4", "local")):
            d = ROOT / "build" / "mesh_train" / f"{arch}_{mesh_spec}"
            shutil.rmtree(d, ignore_errors=True)
            tr = cli.build_trainer(reduced(get_config(arch)), steps=steps,
                                   batch=B_t, seq=S_t, ckpt_dir=str(d),
                                   ckpt_every=100,
                                   mesh=cli.parse_mesh(mesh_spec),
                                   moe_impl=impl, device="cuda")
            runs[arch, mesh_spec] = [h["loss"] for h in tr.run(seed=0)[1]]
    finally:
        torch.use_deterministic_algorithms(False)
    free, sharded = runs["deepseek_moe_16b", None], \
        runs["deepseek_moe_16b", "1x4"]
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded, free)]
    print(f"launch/train.py's trainer, {steps} steps of {B_t} x {S_t} tokens "
          f"on the card: deepseek-moe-16b reduced, mesh-free {free}, --mesh "
          f"1x4 --moe-impl bucket {sharded}, relative |d| "
          f"{['%.2e' % r for r in rel]} (limits {TOL_MESH_FIRST} on the "
          f"first, {TOL_MESH_LOSS}); qwen3-32b reduced (reads no mesh axis)"
          f" mesh-free {runs['qwen3_32b', None]}, --mesh 2x4 "
          f"{runs['qwen3_32b', '2x4']}")
    if len(rel) != steps or rel[0] > TOL_MESH_FIRST or max(rel) > TOL_MESH_LOSS:
        raise AssertionError("the --mesh 1x4 --moe-impl bucket losses "
                             "differ from the mesh-free run's")
    if runs["qwen3_32b", None] != runs["qwen3_32b", "2x4"]:
        raise AssertionError("the dense --mesh 2x4 losses differ")


DRYRUN_CELLS = (("qwen3_32b", "train_4k", False),
                ("gemma2_9b", "decode_32k", True))


def run_dryrun(smi: str):
    """The dry-run phase: ``run_cell`` on ``meta`` at the full widths on
    the 16x16 mesh (virtual): per-device state against the H100's 80 GB,
    counted against analytic FLOPs, the bottleneck (datasheet rates)."""
    from repro_torch.launch import dryrun as dr
    for arch, shape, split_kv in DRYRUN_CELLS:
        r = dr.run_cell(arch, shape, multi_pod=False, split_kv=split_kv,
                        verbose=False)
        t = r["roofline"]
        print(f"dry run {arch} x {shape} on {r['mesh']}"
              f"{' --split-kv' if split_kv else ''}: "
              f"{r['per_chip_state_bytes'] / 2**30:.2f} GiB a device, fits "
              f"80 GB: {r['fits_hbm']}; counted / analytic FLOPs "
              f"{r['flops_counted'] / t['model_flops']:.3f}; bottleneck "
              f"{t['bottleneck']} (analytic, datasheet rates of {smi}); "
              f"built in {r['build_s']} s on meta")
        if r["status"] != "ok" or not r["fits_hbm"] or r["flops_counted"] <= 0:
            raise AssertionError(f"dry-run cell {arch} x {shape}: {r}")



# ---------------------------------------------------------------------------
# The user entry points (``repro_torch.examples``, ``repro_torch.tools``),
# each called as a user calls it, on the card.
# ---------------------------------------------------------------------------

TRAIN_100M_CKPT = ROOT / "build" / "train_100m_ckpt"
TRACE_SMOKE_DIR = ROOT / "build" / "trace_smoke"


def run_entry_microcircuit(net, smi: str) -> dict:
    """The microcircuit example at scale 0.2 on ``torus3d ethernet`` (a
    1x2x2 torus of the 4 shards) on main path 1's network (main path 1 is
    its ``alltoall extoll`` run): seed-0 potentials and a background drive
    drawn on the card; a 1-window warm-up, then the 25-window run with its
    launches counted (flush_window 25, lif_step 25, wire_codec 26: a
    decode per exchange and the final flush's; torus_exchange 26, the
    ring rotation of each), 0 overflows, and the first
    windows card == CPU.  Returns its launches."""
    from repro_torch.examples import multiwafer_microcircuit as ex
    from repro_torch.kernels import dispatch
    transport, fmt = "torus3d", "ethernet"
    cfg = ex.sim_config(net, transport, fmt)
    state, drive, cpu_state, cpu_drive = entry_inputs(net, cfg)
    quiet(lambda: ex.main(transport, fmt, net=net, state=state,
                          drive=drive[:1], n_windows=1, device="cuda"))
    print(f"\n$ python -m repro_torch.examples.multiwafer_microcircuit "
          f"{transport} {fmt} --scale {SCALE}  [{smi}; main path 1's "
          f"network, seed-0 state and a drive drawn on the card, after a "
          f"1-window warm-up]")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    card = ex.main(transport, fmt, net=net, state=state, drive=drive,
                   device="cuda")
    launches = dict(dispatch.LAUNCHES)
    want = {"flush_window": N_WINDOWS, "lif_step": N_WINDOWS,
            "wire_codec": N_WINDOWS + 1, "torus_exchange": N_WINDOWS + 1}
    if launches != want:
        raise AssertionError(f"{transport} {fmt}: launches {launches} != "
                             f"{want}")
    if int(card.stats.overflow.sum()) != 0:
        raise AssertionError(f"{transport} {fmt}: bucket overflows")
    n_int, spikes = check_entry_windows(card, net, transport, fmt,
                                        cpu_state, cpu_drive)
    ms = card.wall_s * 1e3 / N_WINDOWS
    print(f"entry point {transport} {fmt} at scale {SCALE} [{smi}]: "
          f"{ms:.3f} ms a window (25 windows and the final flush, host "
          f"clock, synchronised); launches {launches}; {n_int} integer "
          f"WindowStats / LinkStats fields of the first "
          f"{ENTRY_CHECK_WINDOWS} windows card == CPU; {spikes} spikes in "
          f"them")
    return launches


def run_entry_quickstart(smi: str) -> dict:
    """The quickstart on the card: kernel A once (the aggregation) and G
    once (the cycle model), nothing else; its buckets, final bucket state
    and every cycle output equal to the CPU's on the same draws."""
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import dispatch
    print(f"\n$ python -m repro_torch.examples.quickstart  [{smi}]")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    (buckets, (st, out)), _, losses = qs.main(device="cuda")
    launches = dict(dispatch.LAUNCHES)
    want = {"flush_window": 1, "bucket_trace": 1}
    if launches != want:
        raise AssertionError(f"quickstart launches {launches} != {want}")
    cpu_buckets, (cpu_st, cpu_out) = quiet(
        lambda: qs.spike_aggregation_demo(device="cpu"))
    for what, a, b in (("buckets", buckets, cpu_buckets),
                       ("bucket state", st, cpu_st),
                       ("cycle outputs", out, cpu_out)):
        require_equal(f"quickstart {what} card vs CPU",
                      [(x.cpu(), y) for x, y in zip(a, b)])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"quickstart: the tiny LM's loss {losses}")
    print(f"quickstart: launches {launches}; buckets, bucket state and "
          f"cycle outputs card == CPU bit for bit; the tiny LM's loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return launches


def run_entry_serve_lm(smi: str) -> None:
    """serve_lm twice (the first call warms the allocator and cuBLAS; the
    second's tokens/s is the one to read): the same tokens both times, no
    kernel launched (the dense family is plain PyTorch)."""
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import dispatch
    print(f"\n$ python -m repro_torch.examples.serve_lm  [{smi}; the "
          f"second of two calls]")
    first = quiet(lambda: serve_lm.main(device="cuda"))
    dispatch.reset_launches()
    out = serve_lm.main(device="cuda")
    if dispatch.LAUNCHES:
        raise AssertionError(f"serve_lm launched {dispatch.LAUNCHES}")
    if sorted(out) != list(range(serve_lm.N_REQUESTS)) or any(
            not np.array_equal(out[r], first[r]) for r in out):
        raise AssertionError("serve_lm: the two calls' tokens differ")


def run_entry_train_100m(smi: str) -> None:
    """train_100m at its defaults (200 steps of 8 x 256 tokens, WSD,
    checkpoints every 50 under ``build/``), from an empty checkpoint
    directory: the entry point asserts that the loss falls; no kernel
    launched."""
    import shutil
    from repro_torch.examples import train_100m
    from repro_torch.kernels import dispatch
    shutil.rmtree(TRAIN_100M_CKPT, ignore_errors=True)   # nothing to resume
    print(f"\n$ python -m repro_torch.examples.train_100m --ckpt-dir "
          f"build/train_100m_ckpt  [{smi}]")
    dispatch.reset_launches()
    history = train_100m.main(["--ckpt-dir", str(TRAIN_100M_CKPT)])
    if dispatch.LAUNCHES:
        raise AssertionError(f"train_100m launched {dispatch.LAUNCHES}")
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError("train_100m: a logged loss is not finite")
    shutil.rmtree(TRAIN_100M_CKPT, ignore_errors=True)


def run_entry_trace_smoke(smi: str) -> dict:
    """The trace smoke into ``build/trace_smoke``: it exits 0 (a failure
    raises ``SystemExit`` with its reasons), and the engine's launches are
    one tenant-form F, one encode and one decode a window (the warm-up's
    segment and the drain segments included; each of the two walks, the
    warm-up's and the final one, adds an encode and two decodes).  The
    engine it served (4 shards on a 2x2x1 torus: Z rings of length 1) is
    held to the same engine served on the CPU: every report integer and
    histogram, every segment's ``WindowServeStats`` integer (floats at
    rtol 1e-6) and the global and per-shard recorder rows equal."""
    from repro_torch.convert import flatten
    from repro_torch.kernels import dispatch
    from repro_torch.tools import trace_smoke
    print(f"\n$ python -m repro_torch.tools.trace_smoke --out-dir "
          f"build/trace_smoke  [{smi}]")
    served = {}
    write = trace_smoke.obs_report.write_engine_run

    def spy(out_dir, eng, rep):
        served.update(eng=eng, rep=rep)
        return write(out_dir, eng, rep)

    trace_smoke.obs_report.write_engine_run = spy
    try:
        dispatch.reset_launches()
        if trace_smoke.main(["--out-dir", str(TRACE_SMOKE_DIR)]) != 0:
            raise AssertionError("trace smoke failed")
        launches = dict(dispatch.LAUNCHES)
        entries = dict(dispatch.ENTRY_LAUNCHES)
    finally:
        trace_smoke.obs_report.write_engine_run = write
    meta = json.loads((TRACE_SMOKE_DIR / "meta.json").read_text())
    n = meta["seg_windows"] + meta["windows"] + meta["drain_windows"]
    want = {"repro_admission_tenants": n, "repro_tenant_exchange": n,
            "repro_torus_rotate": 4, "repro_wire_encode": n + 2,
            "repro_wire_decode": n + 4}
    if entries != want:
        raise AssertionError(f"trace smoke: launches {entries} != {want}")

    cpu = trace_smoke.engine("cpu")
    cpu.warmup()
    cpu_rep = cpu.run(trace_smoke.SEGMENTS)
    card, card_rep = served["eng"], served["rep"]
    want_ints = _report_ints(cpu_rep)
    for key, a in _report_ints(card_rep).items():
        if not np.array_equal(a, want_ints[key]):
            raise AssertionError(f"trace smoke: {key} card {a} != CPU "
                                 f"{want_ints[key]}")
    for x, y in zip(card_rep.tenants, cpu_rep.tenants):
        np.testing.assert_allclose([x.max_us, x.mean_us],
                                   [y.max_us, y.mean_us], rtol=1e-6)
    if len(card.window_stats) != len(cpu.window_stats):
        raise AssertionError("trace smoke: segment counts differ card vs "
                             "CPU")
    for k, (a, b) in enumerate(zip(card.window_stats, cpu.window_stats)):
        fa, fb = flatten(a), flatten(b)
        for key in fa:
            if fa[key].dtype.kind == "f":
                np.testing.assert_allclose(fa[key], fb[key], rtol=1e-6,
                                           atol=1e-6, err_msg=key)
            elif not np.array_equal(fa[key], fb[key]):
                raise AssertionError(f"trace smoke segment {k}: {key} "
                                     f"differs card vs CPU")
    rows = [card.recorder_rows()] + [card.recorder_rows(s)
                                     for s in range(trace_smoke.N_SHARDS)]
    if rows != [cpu.recorder_rows()] + [
            cpu.recorder_rows(s) for s in range(trace_smoke.N_SHARDS)]:
        raise AssertionError("trace smoke: recorder rows differ card vs CPU")
    print(f"trace smoke: launches {entries}; card == CPU on every report "
          f"integer and histogram, {len(card.window_stats)} segments of "
          f"WindowServeStats and the global and per-shard recorder rows "
          f"({len(rows[0])} windows); delivered "
          f"{card_rep.delivered.tolist()}")
    return launches


def run_entry_points(net, smi: str) -> dict:
    """The phase of the user entry points (the microcircuit's ``alltoall
    extoll`` run is main path 1); returns their kernel launches, summed."""
    t0 = time.perf_counter()
    total = {}
    for counts in (run_entry_microcircuit(net, smi),
                   run_entry_quickstart(smi), run_entry_trace_smoke(smi)):
        for name, count in counts.items():
            total[name] = total.get(name, 0) + count
    run_entry_serve_lm(smi)
    run_entry_train_100m(smi)
    print(f"\nthe entry-point phase took {time.perf_counter() - t0:.1f} s; "
          f"launches {total}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    from repro_torch.kernels import _build

    banner("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    # f32 products on the main path stay IEEE f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    banner("build")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"kernel library {path.name} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "Compiling entry" in line:
            print("  " + line.strip())
    hgmma = count_hgmma(path, "ssd_chunk_tc")
    print(f"HGMMA instructions in ssd_chunk_tc's SASS: {hgmma}")
    if hgmma == 0:
        raise AssertionError("ssd_chunk_tc has no tensor-core instruction")

    from repro_torch.snn import lif
    from repro_torch.snn import simulator as sim
    gen = torch.Generator(device="cuda").manual_seed(1234)
    per = -(-15431 // N_SHARDS)
    cfg = sim.SimConfig(n_shards=N_SHARDS, per_shard=per, max_fan=4,
                        e_max=1024, capacity=1024, residue=256,
                        params=lif.LIFParams())

    from repro_torch.configs import get_config
    from repro_torch.models.ssm import dims
    lm = get_config(MAMBA_ARCH)
    banner("kernels against their plain versions")
    records = [check_flush_window(gen, cfg, per * cfg.max_fan),
               check_placement(gen, cfg, per * cfg.max_fan),
               check_codec(gen, cfg), check_lif(gen, cfg),
               check_bucket_scatter(gen),
               *check_ssd_chunk(gen, MAMBA_SLOTS * dims(lm)[1],
                                lm.ssm.chunk, lm.ssm.head_dim,
                                lm.ssm.d_state,
                                MAMBA_SLOTS * lm.ssm.n_groups, hgmma)]
    e_grad = check_ssd_chunk_grad(gen, 2 * dims(lm)[1], lm.ssm.chunk,
                                  lm.ssm.head_dim, lm.ssm.d_state,
                                  2 * lm.ssm.n_groups)
    e_record = next(r for r in records if r["name"] == "ssd_chunk")
    e_record["parity"] += (f"; under autograd ({E_GRAD_CHUNKS} chained "
                           f"chunks of {2 * dims(lm)[1]} pairs) the "
                           f"gradients of all 6 inputs == the plain loop's "
                           f"within 2e-4, max abs err {e_grad[1]:.2e}")
    for r in records:
        print(f"{r['name']}: {r['parity']}; device time per call (CUDA "
              f"graph): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); eager "
              f"call from Python: kernel {r['eager_ms']:.4f} ms, plain "
              f"{r['plain_eager_ms']:.4f} ms")

    banner("whole slice, card vs CPU")
    check_slice_small()

    banner("main path 1: microcircuit")
    launches1, net1 = run_main_path(smi.splitlines()[0])
    paths = {"microcircuit, alltoall": launches1}

    banner("the exchange on the card")
    paths["exchange"] = run_exchange_path()

    banner("torus slice, card vs CPU")
    check_torus_slice_small()

    banner("main path 3: microcircuit on the credited torus3d")
    paths["microcircuit, torus3d"], captured, part3, spec3 = \
        run_torus_main_path()

    banner("kernel F, the admission replay, against the plain replay")
    records.append(check_admission(captured))

    banner("fault slice, card vs CPU")
    check_fault_slice_small()

    banner("the fault matrix at main path 3's width")
    run_fault_matrix(part3, spec3)

    banner("observability slice, card vs CPU")
    check_obs_slice_small()

    banner("obs-sim: the flight recorder on main path 3's network")
    obs_launches = run_obs_sim(part3, spec3, smi.splitlines()[0])
    del captured

    banner("main path 16: the full-scale microcircuit over a sparse store")
    net16 = full_scale_network()
    banner("the delivery kernel against its plain version on the "
           "full-scale store")
    records.append(check_synapse_deliver(gen, net16.part))
    paths["microcircuit, full scale"] = run_full_scale_path(
        net16, smi.splitlines()[0])

    banner("main path 17: the window loop, eager against its CUDA graph, "
           "at the microcircuit cells' shapes")
    paths["window loop, one graph turn a cell"] = run_graph_loops(
        graph_loop_cells(part3, spec3.bg_rates(), net16.part,
                         net16.spec.bg_rates()), smi.splitlines()[0])
    del net16, part3
    torch.cuda.empty_cache()

    banner("main path 18: NEST's HPC benchmark network with STDP at the "
           "HPC cell's scale")
    hpc_spec, hpc_part = hpc_network()
    banner("kernel C's alpha form, kernel S's multapse and plastic forms "
           "against their plain versions at the HPC cell's load")
    records.append(check_lif_alpha(gen, HPC_SHARDS, HPC_PER))
    stdp_record, walk = check_hpc_deliver(gen, hpc_part)
    records.append(stdp_record)
    next(r for r in records if r["name"] == "synapse_deliver")[
        "parity"] += walk
    paths["HPC benchmark, replayed segments"] = run_hpc_path(
        hpc_spec, hpc_part, smi.splitlines()[0])
    del hpc_part
    torch.cuda.empty_cache()

    banner("serve slice, card vs CPU")
    check_serve_slice_small()

    banner("main path 4: multi-tenant spike serving, bench_serve's "
           "deployment")
    serve_launches, captured4, serve_reports = run_serve_main_path(
        smi.splitlines()[0])

    banner("obs-serve: the instrumented spike engine, main path 4's "
           "contended run")
    obs_serve = run_obs_serve(smi.splitlines()[0], serve_reports["solo"])
    for name, count in obs_serve.items():
        obs_launches[name] = obs_launches.get(name, 0) + count

    banner("kernel F's tenant form against the plain replay")
    f_record = next(r for r in records if r["name"] == "admission")
    f_record.update(check_admission_tenants(captured4,
                                            smi.splitlines()[0]))
    del captured4

    banner("kernel H, the tenant exchange epilogue, and the ring rotation "
           "against the eager chain")
    records.append(check_torus_exchange(smi.splitlines()[0]))

    banner("kernel G, the cycle models, card vs CPU")
    check_cycle_small()

    banner("main path 5: the cycle-level bucket and ring-buffer models")
    paths["cycle models"], g_records = run_cycle_models(smi.splitlines()[0])
    records.extend(g_records)

    banner("Mamba-2, reduced, card vs CPU")
    check_mamba_small()

    banner("the f32 route of the SSD chunk")
    paths["f32 SSD scan"] = run_ssd_f32_path()

    banner(f"main path 2: serving {MAMBA_ARCH}")
    paths["serving"] = run_mamba_main_path()

    banner("dense transformers, reduced, card vs CPU")
    check_dense_small()

    banner(f"main path 6: serving {GEMMA_ARCH}")
    paths[f"serving {GEMMA_ARCH}"], model, params = run_gemma_main_path(
        smi.splitlines()[0])
    banner(f"main path 13: {GEMMA_ARCH} decoding split-KV over a 1x8 mesh")
    paths[f"split-KV decode {GEMMA_ARCH}"] = run_gemma_split_kv(
        model, params, smi.splitlines()[0])
    banner(f"main path 15: {GEMMA_ARCH} forward, context-parallel runtime")
    paths[f"context-parallel forward {GEMMA_ARCH}"] = \
        run_gemma_context_parallel(model, params, smi.splitlines()[0])
    del model, params

    banner("the rest of the model zoo, reduced, card vs CPU")
    check_zoo_small()

    # one full-width model on the card at a time
    torch.cuda.empty_cache()
    banner(f"main path 7: serving {MOE_ARCH}")
    paths[f"serving {MOE_ARCH}"], model, params = run_moe_main_path(
        smi.splitlines()[0])
    banner(f"main path 14: {MOE_ARCH} prefill, the sharded bucket dispatch")
    paths[f"sharded MoE prefill {MOE_ARCH}"] = run_moe_sharded_prefill(
        model, params, smi.splitlines()[0])
    del model, params
    for title, name, run in (
            (f"main path 7, second part: one {ARCTIC_ARCH} layer",
             f"{ARCTIC_ARCH}, 1 layer", run_arctic_layer),
            (f"main path 8: {VLM_ARCH}", f"serving {VLM_ARCH}",
             run_vlm_main_path),
            (f"main path 9: {RG_ARCH} on ring KV caches",
             f"serving {RG_ARCH}", run_rg_main_path),
            (f"main path 10: {WHISPER_ARCH}", f"serving {WHISPER_ARCH}",
             run_whisper_main_path)):
        torch.cuda.empty_cache()
        banner(title)
        paths[name] = run(smi.splitlines()[0])

    banner("the training path, reduced, card vs CPU")
    check_train_small(smi.splitlines()[0])
    for title, name, run in (
            (f"main path 11: training {MINICPM_ARCH} at full width",
             f"training {MINICPM_ARCH}", run_minicpm_train),
            (f"main path 12: training {MAMBA_ARCH} at full width",
             f"training {MAMBA_ARCH}", run_mamba_train)):
        torch.cuda.empty_cache()
        banner(title)
        paths[name] = run(smi.splitlines()[0])

    torch.cuda.empty_cache()
    banner("distributed: int8 all-reduce, chunked all-to-all, the mesh "
           "trainer")
    run_distributed(smi.splitlines()[0])
    banner("dry run on meta at the production mesh")
    run_dryrun(smi.splitlines()[0])

    torch.cuda.empty_cache()
    banner("the user entry points: the examples and the trace smoke")
    entry_launches = run_entry_points(net1, smi.splitlines()[0])
    del net1

    # each kernel's launches from the path of this slice that runs it (E's
    # tensor-core route on main path 2, serving, and main path 12,
    # training)
    launches = {**paths["microcircuit, torus3d"],
                "bucket_scatter": paths["exchange"]["bucket_scatter"],
                "ssd_chunk": paths["serving"]["ssd_chunk"]
                + paths[f"training {MAMBA_ARCH}"]["ssd_chunk"],
                "ssd_chunk_f32": paths["f32 SSD scan"]["ssd_chunk_f32"],
                **paths["cycle models"]}
    # F and B also run on main path 4 (its three runs), A, B, C and F on
    # the observability phases (obs-sim's recorded runs, obs-serve's
    # instrumented run), A, B and C on main path 1 (the microcircuit
    # example's alltoall extoll run), A, B, C, F, H and delivery (its only
    # path) on main path 16 (the full-scale network's two runs) and A, B,
    # C, F and G on the entry points' phase (the example on torus3d
    # ethernet, the quickstart, the trace smoke); C's alpha form and the
    # plastic delivery (their only path) with A, B, F, H and delivery on
    # main path 18 (the HPC network's replayed segments)
    for counts in (serve_launches, obs_launches,
                   paths["microcircuit, alltoall"],
                   paths["microcircuit, full scale"],
                   paths["HPC benchmark, replayed segments"], entry_launches):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    paths["spike serving (3 runs)"] = serve_launches
    paths["observability (obs-sim recorded, obs-serve instrumented)"] = \
        obs_launches
    paths["the user entry points"] = entry_launches
    for path, counts in paths.items():
        print(f"launches on {path}: {counts}")

    for r in records:           # the per-row placement is on no path: 0
        r["launches"] = launches.get(r["name"], 0)
    print(f"\nchip_smoke ran {time.perf_counter() - t_start:.0f} s, the "
          f"build included")
    print("\nkernels: " + ", ".join(
        f"{r['name']} launches={r['launches']} parity={r['parity']}"
        for r in records))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
