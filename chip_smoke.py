#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py              # on a machine with the card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, tiny
    python3 chip_smoke.py --mesh       # only the phases whose ranks span cards
                                       # (4's last card, 10-14, 19, 21, 22)
    python3 chip_smoke.py --mp         # only the build, the worlds (21) and
                                       # the supervised worlds (26)
    python3 chip_smoke.py --block-stream  # only the build and 22 (four cards
                                          # when the machine has four)
    python3 chip_smoke.py --telemetry  # only the build and 27
    python3 chip_smoke.py --online     # only the build and 28
    python3 chip_smoke.py --traffic    # only the build and 29
    python3 chip_smoke.py --front      # only the build, 30 and 31
    python3 chip_smoke.py --tuning     # only the build and 32
    python3 chip_smoke.py --ingest     # only the build and 33
    python3 chip_smoke.py --x64        # only the build and 34
    python3 chip_smoke.py --wide       # only the build and 35

Phases, each a hard check (any failure exits non-zero):

1. device: ``resolve_device("cuda")``; the card's name and power limit.
2. build: every kernel under ``oap_mllib_tpu_torch/csrc`` with nvcc, one
   process per source, all started together.
3. small: each kernel against its plain version at small ragged shapes,
   every tier and mode (the ALS solve bit for bit; K1 at depths either
   side of 256 and ragged wide ones, 257, 300, 513, 1000, and at 2,100
   centers, several center tiles a group of the wide route); the kernel
   Lloyd loop against the numpy reference, and small PCA and ALS fits against
   their numpy oracles; a nonnegative ALS fit (factors >= 0, within 1e-6
   of the numpy NNLS oracle); the host library's grouped edges bit-equal
   to numpy's at ragged shapes.
4. kernels: the K-Means kernel at the main path's shapes (n = 2^20 rows,
   d = 256, k = 1000, f32 blobs): agreement with its plain version,
   determinism of two launches, the assignment's route (``wgmma``, the
   tensor cores, at every tier for d <= 256), times (CUDA events), the
   bound from the H100 SXM data sheet (highest counted as the six bf16
   products of an f32-accurate split), one PyTorch call as a yardstick,
   and the device time per CUDA kernel of one pass at highest and at
   default (torch.profiler).  The build phase prints how many HGMMA
   instructions the built ``libkmeans_accumulate`` holds and fails on
   none.  With more than one card, K1, K2, K3 and K4 also run on the
   last card against their plain versions.
5. fit (the K-Means path): ``KMeans(k=1000, max_iter=20, tol=1e-4,
   init_mode="k-means||", seed=0).fit(x)``, with every launch count set
   to 0 just before and read just after; then predict and compute_cost,
   and the kernel Lloyd loop against the plain-version loop from the
   same initial centers.
6. pca_kernels: the PCA moments kernel at 2^20 x 128 and 2^18 x 1024,
   every tier, both passes, against its plain version (highest's Gram
   within PCA_GRAM_HIGHEST_RTOL at these shapes, and within
   PCA_GRAM_F64_RTOL of the float64 Gram of its formed values, as at
   every small shape of phase 3, ``PCA_SMALL``); two launches
   bit-equal, the Gram bit-symmetric; the Gram's route (``wgmma``, the
   tensor cores, at every tier for d >= 64); times, bounds (highest
   counted as six bf16 products; its FP32-pipe time on the
   ``pca_variant`` line only), ``torch.matmul(xc.T, xc)`` as yardstick.
   The build phase prints how many HGMMA (tensor-core wgmma)
   instructions the built ``libpca_moments`` holds (``cuobjdump -sass``)
   and fails on none, and fails unless every highest-tier Gram instance
   (``gram_wgmma_kernel<0, VEC>``) holds HGMMA and ptxas reports it with
   no spill.
7. pca_fit (the PCA path): ``PCA(k=16).fit(x)`` at 2^20 x 128 with the
   counts zeroed just before: 2 launches (mean pass, Gram pass); the
   components and ratios against a fit through the plain version.
8. als_kernels: the ALS solve and factor-Gram kernels at the ML-25M
   user side (162,541 systems), r = 10 and r = 32, from moments built on
   the card, against their plain versions: the solve bit-equal on the
   valid rows, the Gram deterministic and bit-symmetric and one CUDA
   kernel per call (counted by torch.profiler in a child process,
   ``--k4-worker``: this process's sessions stop recording kernels after
   the earlier phases'); times, bounds,
   yardsticks ``torch.linalg.solve`` and ``torch.matmul(F.T, F)``.
9. als_fit (the ALS path): implicit ``ALS(rank=10, max_iter=10,
   alpha=40, reg_param=0.1)`` on ML-25M-scale synthetic ratings (162,541
   users x 59,047 items, 25M ratings, zipf(1.3) items, numpy seed) with
   the counts zeroed just before: 20 solve and 20 Gram launches; the fit
   against a plain-version fit from the same initial factors in
   prediction space; an explicit fit (no Gram launch); top-10
   recommendations for a slice of users; ``table_convert`` split into
   the host library's grouped build and the rest; one iteration's device
   time by CUDA kernel with the moments formed through concatenated
   operands (the JAX package's form) and with the copy-free ones
   (torch.profiler; CUDA events for the wall).
   The small phase adds an
   implicit fit at rank 1030 on a tiny table: the factor Gram above the
   kernel's rank bound takes the ``matmul`` route, named in the summary.
10. ring_kernels: the ring allreduce kernel against its plain version,
   bit for bit, for worlds 2 and 4 and segments 1 and 2, at the sharded
   fit's packed buffer (1000, 130), a ragged (13, 37) and (65536, 256)
   (64 MB a rank), and for world 17 (every rank on the one card) at
   (1000, 130); two launches bit-equal; one launch per card per
   ring; times against the bound, the plain ring and a library
   yardstick (``torch.sum(torch.stack(parts), 0)`` on one card,
   ``torch.cuda.nccl.all_reduce`` across cards).
11. sharded_fit (the model-sharded K-Means path): on a (data 2, model 2)
   mesh of four ranks, on four distinct cards when the machine has four,
   else all on the one card: ``lloyd_run_model_sharded`` against the
   one-device ``lloyd_run_kernel`` from the same initial centers near the
   blob centers (equal iterations, centers within 1e-4, cost within
   1e-5), then
   ``KMeans(k=1000, max_iter=20).fit(x)`` at 2^20 x 256 through the mesh
   route with the counts zeroed just before: ``ring_reduce`` launches
   equal to (num_iter + 1) * model * (cards in a ring): one launch per
   card per ring, one ring per model column per pass.
12. als_block_fit (the block-parallel ALS path, run right after als_fit):
   the same implicit fit on four ranks, against the one-device fit in
   prediction space (4096 users x every item, 1e-4); K3 = K4 =
   2 * 4 * max_iter launches; its phases (ratings_shuffle,
   table_convert, als_iterations) and one iteration's device time per
   card.
13. dp_fit (the data-parallel K-Means path): on a (data 4, model 1) mesh,
   its Lloyd loop against the one-device kernel loop from centers near
   the blob centers (equal iterations, centers 1e-4, cost 1e-5), then
   ``KMeans(k=1000, max_iter=20).fit(x)`` on the device list: K1
   launches (num_iter + 1) * 4, no ring; iterations/s.
14. pca_mesh_fit (the PCA path on a mesh): ``PCA(k=16)`` at 2^20 x 128
   on (4, 1) and (2, 2) against the one-device fit (components 1e-4
   sign-insensitively, ratios 1e-5): 8 and 0 K2 launches.
15. stream_kmeans (the streamed K-Means path): the headline table as a
   ``ChunkSource`` of 65,536 rows; ``lloyd_run_streamed`` against the
   one-device ``lloyd_run_kernel`` from centers near the blob centers
   (equal iterations, centers 1e-4, cost 1e-5), K1 launched chunks x
   (iterations + 1) times; the table less its last 12,345 rows (a
   padded last chunk): K1 on its first and last staged chunks against
   the plain version, the padding of no weight (counts, and the cost of
   the valid rows alone), and a streamed cost pass over it against the
   one-device pass (sums 1e-4, counts equal, cost 1e-5); one pass's
   wall, stage / transfer / compute split, the card's idle share
   (torch.profiler) and bound (the larger of its bytes over the pinned
   host-to-device rate this run measures, one 1 GB copy, and K1's
   summed bound); the bare source walk (the first host copy); then ``KMeans(k=1000, max_iter=5).fit(source)``
   with its phases and route.
16. stream_route: ``KMeans.fit(ndarray)`` with ``memory_budget_hbm`` one
   byte below the planner's estimate of the in-memory route streams and
   gives the source fit's result; ``plan_kmeans`` / ``plan_pca`` of a
   2^27 x 256 f32 table (128 GB) under the detected budget say
   "streamed" (the planner alone).
17. stream_pca: the PCA table as a source: K2 launched 2 x chunks times,
   components within 1e-5 (sign-insensitive) and ratios within 1e-5 of
   the in-memory fit; the same under the bf16 policy against the
   in-memory bf16 fit, within the JAX package's registered bf16 bounds
   (subspace 5e-2 rad, ratios 1e-2); at each policy K2 on the first and
   the padded last staged chunk of the table less its last 12,345 rows,
   both passes, against the plain version (the count equal to the valid
   rows), and that table's streamed f32 fit against its in-memory fit
   (1e-5); the two passes' split and bound.
18. stream_als: the implicit ML-25M fit routed streamed by a card budget
   one byte below the in-memory estimate: K3 = K4 = 20, within 1e-5 of
   the in-memory fit in prediction space, iterations/s beside it, one
   iteration's split and bound; a triples ``ChunkSource`` fit on a small
   table against its array fit.
19. als_block_2d (the 2-D ALS layout): rank 32 at the ML-25M shape on
   four ranks with ``als_item_layout="auto"`` (the summary says
   "sharded"), against the one-device rank-32 fit in prediction space
   (1e-4); K3 = K4 = 2 x 4 x 10; K3 and K4 at its per-rank shapes (rank
   0's user and item half-updates from the fitted factors) against their
   plain versions, the solve bit-equal; iterations/s and each card's
   peak memory beside the replicated layout's.  ``--mesh`` runs it on
   four cards.
20. sparse_input: a SciPy CSR table through ``KMeans.fit`` and
   ``PCA.fit``, bit-equal to the fits of its dense copy.
21. The worlds of processes: the script runs itself with ``--mp-worker``
   as the processes of a ``torch.distributed`` world (gloo on
   127.0.0.1), each making only its own rows from the seed; world "a"
   has one rank a process (two processes on the one card; four, a card
   each, under ``--mesh``), world "b" two ranks a process (two
   processes; two cards each under ``--mesh``).  mp_ring (world "a"):
   K5 across the processes over CUDA IPC at the ring shapes, bit-equal
   to the plain version across processes and to the one-process plain
   ring, two launches bit-equal, one launch a process a ring, timed
   against the plain version and the gloo host path; no host collective
   across the timed calls (the collective facade's dispatches, the host
   exchanges and the census's host ops read before and after them), the
   card's waits for the peers (``device_wait_ms``); then the failure
   leg: the last process fails its copy into the workspace on one call,
   every process must raise the agreed RuntimeError naming it within
   10 s, and the next call (a fresh workspace) is bit-equal again.
   World "k" (two processes, on the card only): the second SIGKILLs
   itself inside a K5 call, before it signals; the survivor must raise
   PeerAbortError or CollectiveTimeoutError within 10 s, its stream must
   drain, and it leaves (the world must end within 180 s).  World "b": rings with two members a
   process.  mp_kmeans: the headline fit on (2, 1)
   (k-means||, K1 (iterations + 1) a local rank) and (2, 2) (random,
   K5 one launch a process a ring), iterations/s and the host
   collectives' seconds.  mp_pca: 2^20 x 128 on (2, 1) and (2, 2).
   mp_stream: each process's half as a source of 65,536 rows, the
   streamed Lloyd loop and PCA with their f32 moments through K5 (one
   launch a pass).  mp_als: implicit ML-25M rank 10 on an uneven cut of
   the ratings, two ranks a process (K3 = K4 = 2 x 2 x 10), and rank 32
   in the 2-D layout under ``--mesh``.  Afterwards this process holds
   every fit against the one-process fit of its shape (K-Means:
   iterations equal, centers and cost 1e-5; PCA against one device,
   components 1e-4, ratios 1e-5; streamed: centers 1e-4, cost 1e-5, PCA
   1e-5; ALS 1e-4 in prediction space).  ``--mp`` runs only these.
   mp_block_stream (world "b"): each process's cut of the ML-25M ratings
   as a width-3 source, the streamed block ALS at rank 10 (K3 = K4 = 2 x
   2 x 10 a process), every process's factors against the one-process
   four-rank streamed block fit (bit-equal, or 1e-5 relative).
   mp_balance (world "a"): every process holds the whole headline table
   and takes its extent through ``balance.local_sources``; with
   capabilities pinned 1.0 / 0.5 (even / odd processes) the extents of
   the 2^20 x 256 table (16 chunks of 65,536 rows: 11 / 5 on two
   processes), the streamed Lloyd loop and the streamed PCA against the
   same fits on equal shares within 1e-5, the block ALS on the weighted
   offsets against the equal-share fit within 1e-4 in prediction space
   and, afterwards in this process, each of the two against a float64
   fit of the same ratings (balance_f64: the weighted fit no farther from
   it than twice the equal-share fit), every process's ``balance`` block
   equal; the default ("auto", nothing pinned) weighs the processes 1.0
   each, whatever their probes read; then the drill: equal pinned
   capabilities, process 1's rows slowed by 0.1 s a chunk (a wrapper of
   this script's), the fleet rollups on, threshold 1.3, patience 2: the
   controller must re-plan by the third pass; each pass's walls, skew
   ratios and re-plans printed, K1's launches equal to the chunks the
   passes' extents staged.
22. block_stream (the streamed block ALS, after als_block_2d): the
   ML-25M ratings as a width-3 source on four ranks (four cards under
   ``--mesh``), implicit rank 10 with replicated items and rank 32 in
   the 2-D layout, each against the resident block fit of its rank and
   layout: factors bit-equal (gate 1e-5 relative), K3 = K4 = 2 x 4 x 10
   and the summary's counts equal to the counters; iterations/s,
   ``table_convert``, each card's peak memory beside the resident
   route's, one streamed iteration's idle share by card and the split
   of its host wall (staging, pinned copies, waits, psums).

23. ladder (after small; 2^16 x 64, k = 16): the resilience ladder
   (utils/resilience.py) under injected faults (utils/faults.py), each
   leg's counts zeroed just before its fit and read just after: (a)
   ``stream.read:fail=2,prefetch.stage:fail=1`` on a streamed fit of
   128-row chunks, three retries, centers bit-equal to the unfaulted
   fit; (b) ``fit.execute:oom=2`` at 1024-row chunks, halvings [2, 4],
   the cost within 1e-5 of the fit at 256; a real
   ``torch.cuda.OutOfMemoryError`` (an allocation past the card)
   classified "oom", and a fit under a memory cap between the peaks of
   two chunk widths (fired or not, reported); (c) ``oomhost`` on an
   in-memory fit: the spill rung under a temporary ``spill_dir``, the
   fit bit-equal to the fit of the same source; (d) ``nan`` under the
   bf16 policy: the precision rung, K1 at the bf16 tier in the
   unfaulted fit and at highest in the retry (``LAUNCHES_BY_MODE``),
   the retry bit-equal to the f32 fit; (e) a NaN row raises
   ``NonFiniteError`` naming "centroids", a PCA overflow "Gram"; (f)
   ``fit.execute:oom=*``: ``ResilienceError`` with every halving in its
   history, the plain version never run; (g) a streamed implicit ALS
   from a triples source, ``stream.read:fail=1``, K3 = K4 = 2 x
   max_iter, factors bit-equal.
24. pca_randomized (after pca_fit): ``pca_solver="randomized"`` at 2^18
   x 1024, k = 16, against eigh on the same table (ratios 1e-4
   relative, |cosines| > 1 - 1e-4), K2 twice a fit; both fits' walls
   and both solvers' times on the covariance, with the card's name and
   power limit.
25. ckpt (after als_block_fit; checkpoints under the port's build
   directory, removed afterwards), each leg's counts zeroed just before
   its fit: (a) the headline K-Means fit unarmed, armed
   (``checkpoint_interval`` 5), armed to 10 iterations and resumed to
   20: centers bit-equal to the armed full fit, equal iterations and
   cost, K1 launched once per resumed iteration and once per segment's
   cost pass and held against its plain version at the resumed centers;
   the walls, ms per write and restore ms; (b) the implicit ML-25M ALS on
   one device, unarmed, armed (interval 3), armed to 5 and continued to
   10: factors bit-equal, K3 = K4 = 2 x 5 in the resumed part, each held
   against its plain version at the resumed factors; (c) the streamed
   PCA table fitted twice: the second restores the column sums and K2
   runs only the Gram pass (once a chunk), components bit-equal, K2 on
   the staged chunks against its plain version; (d) a child
   ``chip_smoke.py --ckpt-worker`` on the card running the armed headline
   fit (interval 2) SIGKILLed by the ``kill`` chaos kind at Lloyd pass 3
   (exit -9), then relaunched with resume=auto: bit-equal to the
   uninterrupted armed fit; (e) the block ALS on four ranks checkpointed
   at iteration 2 and resumed with ``num_user_blocks=2``: "resharded",
   within 1e-5 of the uninterrupted fit or, when larger, of the two
   layouts' own distance (the JAX package's elementwise bound reported).
26. supervise (with ``--mp`` and ``--mesh``): utils/supervisor.Supervisor
   launches ``chip_smoke.py --sup-worker`` processes, two on the one card
   (a card each under ``--mesh``), each streaming its half of the
   headline table through K-Means and fitting the block ALS on its cut
   of the ratings, with checkpoints and the crash sideband: the
   uninterrupted world; a seeded chaos kill of process 1 in the ALS
   (the survivor a ``peer_abort`` victim with its crash record, one
   relaunch, results bit-equal to the uninterrupted world's); the same
   with ``shrink_after=1`` (one process at the end, K-Means within 1e-5
   of the two-process world, ALS within 1e-5 of the one-process fit or
   of the two-process fit's own distance from it); each attempt's
   classification, the detection-to-respawn walls and the steps lost.
   The worlds of 21 time the gloo host path with the recovery watcher
   armed (the default) and disarmed, in turns, and with the collective
   sanitizer off and on.  Every process runs with
   the flight recorder (4096 slots) and the collective sanitizer armed:
   the survivor's crash record must carry a recorder tail and the
   sanitizer's fingerprint.
27. telemetry (after ladder, in a child process ``--tel-worker``: a
   process's profiler sessions stopped recording the kernels once
   this phase's and the others' had run in it): the observability
   plane on the headline K-Means, PCA, ML-25M ALS and the sharded
   K-Means on four ranks (K5), each fit run with every plane off and armed
   (``telemetry_log``, ``metrics_port`` on a free port,
   ``flight_recorder=4096``, every sanitizer, ``profile_dir``), in
   turns, three times each: (a) the armed fits bit-equal to the unarmed
   ones; (b) each kernel's ``LAUNCHES`` count, the
   ``oap_kernel_launches_total`` family and the span tree's ``kernels``
   equal, counts zeroed just before each fit; (c) ``GET /metrics`` holds
   the fit, kernel and program-cache families and ``GET /healthz`` the
   JAX package's keys; (d) the JSON-lines sink one record a span and one
   snapshot a fit; (e) the profiler trace names each hand-written kernel
   of the path (one trace of the three at least: the tracer has dropped
   a session's kernels), its summed device ms inside the fit and share
   of the armed wall printed; (f) the median walls off and armed, beside
   the first-fit walls of two runs before the plane; (g) the streamed K-Means (k-means||), PCA and
   ALS under the transfer and retrace sanitizers bit-equal to unarmed,
   and a planted ``.item()`` in a streamed consumer body raising.
   Under ``--mp`` world "c" (two processes) plants an extra collective
   on process 1 under the collective sanitizer: both processes raise
   ``CollectiveDivergenceError`` naming both ops, well inside the
   collective timeout.

28. serve_online (after als_block_fit; the serving core and the online
   updates on the headline K-Means model and the ML-25M ALS model of
   phases 5 and 9, each update on a copy where a later phase reads the
   model; ``--online`` fits both itself): (a) ``serving.serve`` of the
   K-Means model, ``warmup(4096)``, 200 requests of 1–4096 rows each
   bit-equal to ``model.predict``, >= 99.99 % of labels equal to a
   float64 numpy assignment, no program-cache miss and no build after
   the warmup, p50 / p99 ms, requests/s, pad rows; ``predict_many`` of
   16 small requests; (b) ``IncrementalPCA(16)`` over the 2^20 x 128 PCA
   table in 16 chunks of 65,536 rows (K2 = 16) against ``PCA(16).fit``
   (components 1e-4 sign-insensitively, ratios 1e-5), served, a second
   delta re-pins it (version 2, bit-equal to ``model.transform``); (c)
   the streamed sweep of the ML-25M model and of a 1,000,000 x 256,
   rank-16 table, bit-equal to ``recommend_for_all_users``, ids against
   a float64 top-10 of 4,096 users off near-ties (every gap of the 11
   best float64 scores above 1e-5 of the best), peak memory within the
   chunk's budget, users/s; (d) 10,000 new users (6 ratings each, drawn
   like the base's) folded into a served copy of the ML-25M model: K3 =
   K4 = 1, rows bit-equal to the COO half-update of the same edges, the
   grown tail's untouched rows at the init, within 0.15 of a refit on
   base plus delta in prediction space, the fold-in and refit walls; a
   second delta in the same buckets misses nothing; batched by 2,048
   rows, five launches of each and the same rows; (e) ``partial_fit`` of
   a 2^18 x 256 delta of the same blobs in 65,536-row chunks (K1 = 4):
   centers within 1e-5 of the plain K1's fold on the CPU, counts exact,
   the served handle at version 2 and bit-equal to ``model.predict``;
   (f) ``delta.ingest:err=1`` on (e), ``delta.solve:err=2`` on (d)
   with batches of 2,048 (the count fires the first two calls: before
   any launch), and on (d) the second batch's solve made to raise after
   the first batch's K3 and K4 ran, each leave the arrays, the served
   answers and the versions as they were.
29. serve_traffic (after serve_online, on its K-Means model; ``--traffic``
   fits it itself): the serving front, launch counts zeroed before each
   leg and read after.  (a) after ``warmup(4096)``, 2,000 requests of
   1–4096 rows (uniform, ``bench.py --serving``'s law) from 4
   closed-loop clients of 16 in flight through one ``TrafficQueue``
   (flushes of at most 4,096 rows), with no deadline and with 50 ms:
   every future resolves exactly once, >= 99.99 % of labels equal the
   float64 argmin, each answer bit-equal to ``predict_many`` of its own
   flush group (a spy handle records the groups), no program-cache miss
   or build, no kernel launch; p50 / p99 from submit, requests/s, rows
   a flush, sheds by reason; (b) the same storm at
   ``serve_trace_sample=1`` with the SLO engine (50 ms) and the metrics
   endpoint on: every ledger's stages within 1 us of its wall, one
   ``request`` record in the sink a sampled request, exemplars on
   ``/metrics``; per-stage p99, then the storm untraced again (the armed
   over off wall); (c) a burst of 20 at ``serve_queue_depth=8`` (12
   ``queue_full``, the 8 bit-equal to ``predict_many`` of their flush);
   ``serve_shed_headroom`` at half a full request's bytes over the
   detected budget: budget sheds, then topk -> bf16 -> stale, each step
   booked, breaches absorbed, then the budget shed again; the bf16
   rung's answers bit-equal to ``model.predict`` under
   ``serving_precision="bf16"``, their agreement with f32 recorded; (d)
   under ``pin:stale`` (scoring pinned to f32) a storm of 1,500 spans
   ``partial_fit`` of 2^18 headline rows: K1 = 4, no failed future,
   labels the float64 argmin under the old or the new centers, the
   version up by one; (e) ``bench.py:1463``'s degraded storm (stale
   rung, ``serve.dispatch:fail=2``, two NaN requests): exactly the two
   quarantined (``oap_serve_poison_total`` +2), retries booked, the
   rest answered; a drain with pending work posts its report and the
   supervisor's ``_read_drain_reports`` reads it; (f) ``GET /sloz`` and
   ``/healthz`` over localhost: the JAX payloads' keys, the burn rates;
   (g) two replicas, a process each on the one card
   (``--ha-worker``), each its own queue: one heartbeat view of both,
   process 1 SIGKILLed, the survivor's ``ReplicaGuard`` evicts it
   (``oap_serve_evictions_total`` +1) and answers bit-equal to before;
   its scale decision lands in ``serve.scale.hint.json`` and the
   supervisor's ``_read_scale_hint`` reads it.

30. serve_sharded (after als_block_2d; the factor-sharded serving on the
   block fits' live layouts; ``--front`` fits them itself): (a) phase
   12's ML-25M model (rank 10, replicated items, four ranks), which the
   fit handed over without a gather (``summary["sharded_factors"]``):
   ``sweep.recommend_for_all_users(model, 10, with_scores=True)`` runs
   the per-rank fold of each user block against the pinned item table,
   no kernel launched, held against the streamed sweep of the gathered
   tables (ids equal on >= 99.99 % of the users, scores within 1e-6 of
   their scale); users/s and each card's peak memory beside the streamed
   sweep's; the same tables placed by ``shard_factors_local`` over the
   four ranks sweep bit-equal to the live layout; (b) the same for phase
   19's rank-32 model on the 2-D layout, the item blocks rotating
   (``oap_serve_ring_hops_total`` up by the world a sweep); (c) world
   "a", two processes on the one card (``--sweep-worker``): the rank-10
   tables placed by ``shard_factors`` on the world's 2-D layout, both
   processes' sweeps bit-equal and within the gate; process 1 SIGKILLs
   itself, process 0's heartbeat evicts it, its next sweep is refused
   (``PeerAbortError``) and re-forms once on its own card through
   ``reform``, answering within the gate (``oap_serve_sweep_reforms_total``
   1).  Under ``--mesh`` the four ranks lie on four cards.
31. front_doors (after serve_sharded): the Spark-API compat layer on the
   card, launch counts zeroed before each fit: (a)
   ``compat.spark.KMeans().setK(1000).setMaxIter(20).setInitMode("k-means||")
   .setSeed(0).fit({"features": x})`` at 2^20 x 256: K1 as often as
   phase 5's native fit, centers bit-equal to it; transform and the
   ``ClusteringEvaluator`` silhouette of 65,536 rows; (b)
   ``compat.spark.PCA().setK(16)`` at 2^20 x 128: two K2 launches,
   components within 1e-4 of the native fit; (c) ``compat.spark.ALS``
   at the ML-25M table, rank 32, ``setNumUserBlocks(4)`` on four ranks:
   K3 = K4 as phase 19's native fit, the live 2-D layout kept,
   ``recommendForAllUsers(10)`` through the ring sweep (hops booked)
   bit-equal to (b) of phase 30, ``transform`` with
   ``coldStartStrategy="drop"`` (1,000 cold rows dropped) and the
   ``RegressionEvaluator``; (d) a small ``Pipeline`` (PCA, K-Means)
   saved, loaded and run bit-equal; (e) the pyspark adapter on a
   duck-typed DataFrame against the dict plane; (f) the port's
   ``examples/run_all.sh`` on the card, each example exit 0.

32. tuning (last; the kernel-geometry autotuner,
   ``ops/cuda/autotune.py``, and the trace merger), launch counts zeroed
   before each leg and read after: (a) every candidate of each kernel's
   grid against the default geometry and the plain version: K1 at the
   main table (2^20 x 256, k = 1000) at highest and default (labels
   equal; sums and counts bit-equal where only ``range_rows`` moves,
   within 1e-6 of max(1, max |ref|) where ``parts`` does), K2 at 2^20 x
   128 at highest and high (both passes within 1e-6), K3 at the ML-25M
   user side, r = 10 and 32 (every bit), K4 there (within 1e-6), K5 at
   the sharded fit's packed buffer (bit-equal to the plain ring) and the
   model-sharded fit on one card at 1, 2 and 4 segments (bit-equal,
   the same K5 launches, 42); each candidate's ms printed; (b) under
   ``tuning="on"`` with a fresh ``tuning_cache_dir``, a K-Means (2^18 x
   256, k = 1000), a PCA (2^18 x 128) and an implicit ALS (rank 10) fit,
   in the main paths' buckets: each kernel swept exactly once (the
   summaries and ``oap_tuning_sweeps_total``), each sweep's wall and
   winner printed, each fit launching what an untuned fit launches;
   then a child process (``--tune-worker``) sharing the directory: every
   kernel a ``hit``, no sweep, the same geometry, every array bit-equal;
   (c) under a non-default pin of every kernel against the defaults:
   the fit's K1 Lloyd loop from centers near the blob centers (centers
   within 1e-6, equal iterations and launches), the PCA and ALS fits
   (ratios within 1e-6, components within 1e-4; ALS factors within 1e-6
   or twice the default fit's distance from its twin with K4's plain
   version, the ALS solve's pin alone bit-equal);
   (d) world "a" (two processes on the card) fits K-Means under
   ``tuning="on"``: process 0 sweeps through ``resolve_world``, process 1
   records the same geometry as a hit (``--tuning`` runs world "a" with
   only this step); (e) ``tools/oaptrace.py`` merges phase 27's
   JSON-lines sink and world "a"'s: ``validate_trace`` finds nothing;
   the tracks, flows and request lanes printed.

33. ingest (last; the native host layer, ``native/`` and ``data/io.py``,
   files under a temp directory removed at the end; the text written by
   numpy-only writer processes, a slice each; one small fit of each estimator first,
   so no timed fit pays a library's load), counts zeroed before each
   fit: (a) the
   ML-25M ratings of phase 9 as MovieLens ``ratings.dat`` lines
   ``u::i::r::ts`` (the rating ``%.9g``) parsed by the host library: ids
   bit-equal to the source as int64, ratings as float32, the seconds and
   MB/s; the plain Python reader on the first 2^20 lines bit-equal to
   the host parse there, its seconds; the implicit ALS (rank 10, alpha
   40, reg 0.1, 10 iterations, ``num_user_blocks=1``) from the parsed
   triples: K3 = K4 = 20, factors bit-equal to the fit from the arrays,
   both walls; (b) the shuffle prep of the 25M ratings into 4 blocks
   bit-equal to numpy's lexsort, both times and the block-only radix
   argsort's, and the prep's parts: the permutation's seconds, and the
   gather of the three arrays by the library against numpy's ``a[perm]``
   (bit-equal); (c) a 2^18 x 256 libsvm file at the sparse phase's ~32 % density
   (values rounded to 6 decimals, printed ``%.9g``): the parse bit-equal
   to the source in float64, the plain reader on its first 16,384 rows
   bit-equal, ``KMeans(k=100, seed=0)`` from it (K1 = iterations + 1)
   bit-equal to the fit from the array; (d) a dense 2^17 x 128 CSV:
   ``PCA(k=16)`` from it (K2 = 2) bit-equal to the fit from the array;
   (e) ``local_ip`` and a ``free_port`` printed, a table store round trip
   through ``torch.from_numpy`` of a ``table_view``, the live table count
   back where it started.

Every mesh phase puts its four ranks on four distinct cards when the
machine has four, else on the one card.

34. x64 (last; the float64 parity lane, ``set_config(enable_x64=True)``
   for the phase and off after it), launch counts zeroed before each
   fit and read after: the registers, static shared bytes and spills
   that ptxas reported for the float64 forms' DMMA kernels; (a0) both
   float64 forms at ragged shapes (depths 1, 29, 37, 128, 129, 300)
   against their plain versions: K1 both modes to 1e-12 with labels >=
   99.99 %, K2's masked mean and Gram passes to 1e-12, the Gram
   bit-symmetric, two launches bit-equal; (a) K1's float64 form at the main path's shape
   (2^20 x 256 f64 blobs, k = 1000), loop and cost mode, against its
   plain version on the card: labels >= 99.99 %, sums and counts on the
   kernel's labels and the cost within 1e-12 relative, two launches
   bit-equal; ms a launch, the bound (2 n k d operations at the FP64
   tensor cores' 67 TFLOP/s, 8 bytes an element), the FP64 pipe's 34
   TFLOP/s time beside it, the plain version's ms and
   ``torch.matmul(x, c.T)`` in f64, and the device ms of each of the
   pass's kernels (torch.profiler: the DMMA assignment beside the whole
   pass); (b) K2's float64 form at 2^20 x 128 and at 2^18 x 1024:
   column sums and the Gram within 1e-12 relative, bit-symmetric and
   deterministic, ms, bound, plain and ``torch.matmul(xc.T, xc)`` in
   f64, the Gram kernel's device ms;
   (c) ``KMeans(k=1000, max_iter=20, seed=0)`` on the 2^20 x 256 f64
   table (resident: the planner's route in-memory or chunked at 8 bytes
   an element): K1 num_iter + 1 times, all float64, centers
   within 1e-9 of the same fit through the plain version with equal
   iterations; ``PCA(k=16)`` at 2^20 x 128: K2 twice, components within
   1e-9 of a float64 numpy eigh of the host covariance; each fit's wall
   beside the f32 fit of the same rows and their distance; (d) at 2^18
   rows in 8 chunks: the streamed Lloyd loop against the in-memory
   kernel loop from the same centers (1e-9, K1 = chunks x (iterations +
   1)), a streamed K-Means fit, a streamed PCA against the in-memory
   one (1e-9, K2 = 16), ``partial_fit`` of 2^16 rows in 4 chunks against
   the CPU's plain fold (1e-9, K1 = 4), ``IncrementalPCA`` in 4 deltas
   (raw moments 1e-12 of numpy's, the commit 1e-9 of the batch fit, K2 =
   4), and a data-parallel (4, 1) and a model-sharded (2, 2) f64 fit
   against the one-card fit (1e-9, equal iterations, K5 = 0: the ring
   packs f32); (e) a short implicit ALS fit with the flag on and off:
   K3 and K4 launch as before, the factors bit-equal.

35. kmeans_wide (run after phase 5's fit and loop parity; K1 on rows
   wider than 256 features, the ``wgmma_wide`` route of
   ``csrc/assign_wide.cuh``): the HGMMA instructions of the built
   ``libkmeans_accumulate`` in each route's kernels (``cuobjdump
   -sass``; fails when the wide route has none); at 2^20 x 512 and 2^20 x
   960 (GIST1M's width) f32 blobs, k = 1000, every tier and both modes,
   K1 against its plain version (labels >= 99.99 %, sums, counts and cost
   within the ``compare`` bounds, two launches bit-equal), its route, ms
   a launch, the plain version's ms, the bound (one bf16 product or six
   at the tensor-core peak) and ``torch.matmul(x, c.T)`` at the tier's
   operand type (f32 at highest, bf16 else) as yardstick; then
   ``KMeans(k=1000, max_iter=20, init_mode="k-means||", seed=0).fit(x)``
   on the 2^20 x 960 table with the counts zeroed just before: K1 =
   num_iter + 1, every launch on the wide route; the same fit with its
   Lloyd loop on the plain version (the same k-means|| init: cost within
   1e-4; iterations and centers recorded, as two centers seeded in one
   blob split its rows at near-ties); the kernel Lloyd loop against the
   plain-version loop from centers near the blob centers (equal
   iterations, centers within 1e-4 of their scale, cost within 1e-4, as
   phase 5 holds its loop);
   ``predict`` (int32 labels in range) and ``compute_cost`` (within 1e-4
   of the training cost) on the model.  Phase 3 holds the route at
   ragged wide shapes first.

The last three lines are the kernels JSON, the card from nvidia-smi and
``{"ok": true, "device": {...}}``.  ``--rehearse`` runs every phase on
the CPU at tiny sizes and never prints the ok line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from oap_mllib_tpu_torch import (ALS, PCA, ALSModel, KMeans, KMeansModel, config, get_mesh,
                                 set_config)
from oap_mllib_tpu_torch.online import IncrementalPCA
from oap_mllib_tpu_torch.data.prefetch import Prefetcher, PrefetchStats
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.data.table import ShardedTable
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.fallback.kmeans_np import lloyd_np
from oap_mllib_tpu_torch.fallback.pca_np import pca_np
from oap_mllib_tpu_torch.ops import (als_block, als_block_stream, als_ops, als_stream, kmeans_ops,
                                     pca_ops, stream_ops)
from oap_mllib_tpu_torch.ops.cuda import (_build, _gram, _tiers, als_kernel, autotune,
                                          kmeans_kernel, pca_kernel, ring_kernel)
from oap_mllib_tpu_torch.parallel import balance, collective
from oap_mllib_tpu_torch.telemetry import fleet
from oap_mllib_tpu_torch.telemetry import metrics as tel_metrics
from oap_mllib_tpu_torch.utils import checkpoint as ckpt_mod
from oap_mllib_tpu_torch.utils import faults, membudget, profiling, resilience
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import resolve_device, resolve_devices
from oap_mllib_tpu_torch.utils.timing import Timings

FULL = {"n": 1 << 20, "d": 256, "k": 1000}
TINY = {"n": 4133, "d": 29, "k": 11}
# K1 above d = 256 (phase 35): 2^20 rows at 512 and at GIST1M's 960
# features, k = 1000; the fit on the 960-wide table
WIDE_FULL = {"shapes": [(1 << 20, 512), (1 << 20, 960)], "k": 1000, "fit": (1 << 20, 960),
             "max_iter": 20}
WIDE_TINY = {"shapes": [(3001, 300), (2000, 520)], "k": 13, "fit": (3001, 300),
             "max_iter": 3}
TIERS = ("highest", "high", "default")
# sums/counts tolerance on the same labels: highest/high sum f32 values
# (exact bf16 parts for high) in another order; default sums
# bf16-rounded values, whose order-dependent error is ~1e-3
RTOL = {"highest": 1e-4, "high": 1e-4, "default": 1e-2}
MIN_AGREEMENT = 0.9999
# H100 SXM data sheet: FP32 (no tensor cores), bf16 dense, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
REPLACES = "oap_mllib_tpu/ops/pallas/kmeans_kernel.py:90"
PCA_REPLACES = "oap_mllib_tpu/ops/pallas/pca_kernel.py:58"
SOLVE_REPLACES = "oap_mllib_tpu/ops/pallas/als_kernel.py:65"
GRAM_REPLACES = "oap_mllib_tpu/ops/pallas/als_kernel.py:318"
RING_REPLACES = "oap_mllib_tpu/ops/pallas/ring_reduce.py:105"
# the ring: the sharded fit's packed (k, d / model + 2) buffer, a ragged
# one and a bandwidth-sized one; the sharded fit on a (2, 2) mesh
RING_FULL = {"shapes": [(1000, 130), (13, 37), (65536, 256)], "worlds": (2, 4),
             "segments": (1, 2), "wide": (17, (1000, 130))}
RING_TINY = {"shapes": [(1000, 130), (13, 37), (512, 256)], "worlds": (2, 4),
             "segments": (1, 2), "wide": (17, (1000, 130))}
SHARDED_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "data": 2, "model": 2}
SHARDED_TINY = {"n": 4133, "d": 29, "k": 11, "max_iter": 5, "data": 2, "model": 2}
# the data-parallel K-Means path: the main shape on four ranks
DP_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "data": 4}
DP_TINY = {"n": 4133, "d": 29, "k": 11, "max_iter": 5, "data": 4}
# NVLink between two H100 SXM cards of one host: 450 GB/s each way
PEAK_NVLINK = 450e9
# PCA: the JAX bench's headline shape, and a wide one that tiles the
# output; ALS: the JAX bench's ML-25M scale (bench.py bench_als_large)
PCA_FULL = {"shapes": [(1 << 20, 128), (1 << 18, 1024)], "k": 16}
PCA_TINY = {"shapes": [(3001, 37), (777, 140)], "k": 5}
# small ragged tables over both Gram routes: SIMT below d = 64, wgmma at
# every tier from d = 64 (4-byte copies where d is not a multiple of 4),
# one and several output tiles, and a ragged last tile of many (1030)
PCA_SMALL = ((1000, 5), (3001, 37), (4099, 64), (2000, 67), (777, 140), (513, 300),
             (1000, 1030))
ALS_FULL = {"n_users": 162_541, "n_items": 59_047, "nnz": 25_000_000,
            "rank": 10, "alpha": 40.0, "reg": 0.1, "max_iter": 10,
            "explicit_iter": 3, "ranks": (10, 32), "wide_rank": 32, "layout_2d": "auto"}
ALS_TINY = {"n_users": 700, "n_items": 300, "nnz": 20_000, "rank": 10,
            "alpha": 40.0, "reg": 0.1, "max_iter": 3, "explicit_iter": 2,
            "ranks": (10, 32), "wide_rank": 32, "layout_2d": "sharded"}
# the ratings of the streamed block ALS as a width-3 (user, item, rating)
# source: rows a chunk of it
ALS_SOURCE_ROWS = 1 << 20
# the streamed paths: the headline K-Means table in 65,536-row chunks
# (the default width), a five-iteration streamed fit (each pass walks
# the 1 GB table through the host); the PCA table; the sparse table
# the ragged checks drop the table's last ``cut`` rows, so its last chunk
# is part padding (weight 0)
STREAM_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "chunk_rows": 1 << 16, "fit_iter": 5,
               "cut": 12_345}
STREAM_TINY = {"n": 4133, "d": 29, "k": 11, "chunk_rows": 1024, "fit_iter": 3, "cut": 345}
STREAM_PCA_FULL = {"shapes": [(1 << 20, 128)], "k": 16, "chunk_rows": 1 << 16, "cut": 12_345}
STREAM_PCA_TINY = {"shapes": [(3001, 37)], "k": 5, "chunk_rows": 1024, "cut": 345}
SPARSE_FULL = {"n": 1 << 16, "d": 256, "k": 100, "pca_k": 16}
SPARSE_TINY = {"n": 2000, "d": 40, "k": 6, "pca_k": 4}
# PCA moments: colsum/count against the plain version; the Gram by tier
# against the array scale (default sums bf16-rounded products)
PCA_SUM_RTOL = 1e-6
PCA_GRAM_RTOL = {"highest": 1e-4, "high": 1e-4, "default": 1e-2}
# highest's Gram at the main shapes (pca_data), tighter: between the
# sound kernel's reading and the high tier's, which drops the products
# a1 b1, a0 b2 and a2 b0 (on an H100: 6.33e-7 and 4.64e-6 at 2^20 x 128,
# 3.53e-6 and 2.15e-5 at 2^18 x 1024)
PCA_GRAM_HIGHEST_RTOL = {(1 << 20, 128): 2e-6, (1 << 18, 1024): 1e-5}
# highest's Gram against the float64 Gram of the f32 values it forms,
# (x - mean) * mask, at every shape: the plain f32 Gram errs by as much
# as a dropped small product does (3.7e-6 at 2^18 x 1024 on an H100),
# the sound kernel by 3.6e-7 and 2.7e-7 at the main shapes, one with
# a1 b1 dropped by 3.0e-6 and 3.1e-6
PCA_GRAM_F64_RTOL = 1e-6
# kernels-line keys derived from a shape and a peak rate, not measured:
# kept on their phase's own lines
PIPE_KEYS = ("fp32_pipe_ms", "fp64_pipe_ms")
# components (sign-insensitive, ratio > 1e-5) and ratios of the kernel
# fit against the plain-version fit
PCA_FIT_TOL = 1e-4
SOLVE_RTOL = 1e-5
ALS_FIT_RTOL = 1e-3
# the resilience ladder's legs: a small table in 128- and 1024-row
# chunks, and a small ratings table for the streamed ALS leg
LADDER_FULL = {"n": 1 << 16, "d": 64, "k": 16, "rows": (128, 1024), "max_iter": 5,
               "oom_rows": 1 << 20,
               "als": {"n_users": 20_000, "n_items": 5_000, "nnz": 400_000, "rank": 10,
                       "max_iter": 3}}
LADDER_TINY = {"n": 4133, "d": 29, "k": 11, "rows": (128, 1024), "max_iter": 3,
               "oom_rows": 4096,
               "als": {"n_users": 300, "n_items": 120, "nnz": 5_000, "rank": 10,
                       "max_iter": 2}}


class Failed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failed(what)


def emit(tag, payload):
    print(f"{tag} {json.dumps(payload, sort_keys=True)}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def count_sass(lib, opcode):
    """Instructions of ``opcode`` in a built library's SASS."""
    return sum(count_sass_by_function(lib, opcode).values())


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps, warm=1):
    """Mean ms per call: CUDA events around ``reps`` calls on the card,
    the host clock in a rehearsal."""
    for _ in range(warm):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def blobs(n, d, k, dev, seed, spread=2.0):
    """Gaussian blobs made on the device from a seed: rows, fractional
    row weights, and centers near the blob centers."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    true = torch.randn((k, d), generator=g, device=dev) * spread
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = true[lab] + torch.randn((n, d), generator=g, device=dev)
    w = 0.5 + torch.rand((n,), generator=g, device=dev)
    c = true + 0.5 * torch.randn((k, d), generator=g, device=dev)
    return x.contiguous(), w, c.contiguous()


def run_kernel(x, w, c, mode, need_cost):
    """(sums, counts, cost, labels) of the kernel; on the CPU (rehearsal)
    the wrapper's plain version and its labels."""
    if x.device.type == "cuda":
        return kmeans_kernel._launch(x, w, c, mode, need_cost)
    sums, counts, cost = kmeans_kernel.lloyd_accumulate(x, w, c, mode, need_cost)
    labels, _ = kmeans_kernel.assign_plain(x, c, mode, need_cost)
    return sums, counts, cost, labels


def _rel_err(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.clamp_min(torch.max(torch.abs(b)), 1e-30))


def pca_gram_rtol(mode, n, d):
    """The Gram pass's limit against its plain version at one tier and
    shape: PCA_GRAM_HIGHEST_RTOL at highest's main shapes, else the
    tier's PCA_GRAM_RTOL."""
    if mode == "highest":
        return PCA_GRAM_HIGHEST_RTOL.get((n, d), PCA_GRAM_RTOL[mode])
    return PCA_GRAM_RTOL[mode]


def gram_f64(x, mask, mean):
    """The float64 Gram of the f32 values the kernel forms, (x - mean) *
    mask."""
    xc = ((x - mean[None, :]) * mask[:, None]).double()
    return xc.T @ xc


def measured(v):
    """A variant as the kernels line carries it: without PIPE_KEYS."""
    return {k: x for k, x in v.items() if k not in PIPE_KEYS}


def compare(x, w, c, mode, need_cost):
    """One kernel variant against its plain version: labels, sums and
    counts on the kernel's labels, cost, and a second launch's bits."""
    k = c.shape[0]
    sums, counts, cost, labels = run_kernel(x, w, c, mode, need_cost)
    again = run_kernel(x, w, c, mode, need_cost)
    same = all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip((sums, counts, cost, labels), again)
    )
    check(same, f"{mode}/cost={need_cost}: two launches differ")
    ref_labels, _ = kmeans_kernel.assign_plain(x, c, mode, need_cost)
    agree = float((labels.long() == ref_labels).float().mean())
    check(agree >= MIN_AGREEMENT,
          f"{mode}/cost={need_cost}: labels agree on {agree:.6f} of rows")
    ref_sums, ref_counts = kmeans_kernel.sums_for_labels(x, w, labels, k, mode)
    err_s, err_c = _rel_err(sums, ref_sums), _rel_err(counts, ref_counts)
    check(err_s <= RTOL[mode] and err_c <= RTOL[mode],
          f"{mode}/cost={need_cost}: sums rel err {err_s:.3g}, counts {err_c:.3g}")
    out = {
        "mode": mode, "need_cost": need_cost, "label_agreement": agree,
        "sums_rel_err": err_s, "counts_rel_err": err_c,
        "max_abs_err": float(torch.max(torch.abs(sums - ref_sums))),
        "deterministic": same,
    }
    if need_cost:
        _, _, ref_cost = kmeans_kernel.lloyd_accumulate_plain(x, w, c, mode, True)
        err = abs(float(cost) - float(ref_cost)) / max(abs(float(ref_cost)), 1e-30)
        # the cost sums w * min d2: at the bf16 tiers d2 carries the
        # cancellation of a bf16 cross term, so only highest is tight
        tol = 1e-4 if mode == "highest" else 1e-2
        check(err <= tol, f"{mode}: cost rel err {err:.3g}")
        out["cost_rel_err"] = err
    return out


def bound(n, d, k, mode):
    """Least time of one pass, whatever runs it: x, w and the centers read
    once, the sums written once; the cross term at the tensor-core peak,
    at highest as the six bf16 products of an f32-accurate split (the
    fastest f32-accurate product on this card), one product at the bf16
    tiers."""
    products = 6 if mode == "highest" else 1
    ops = products * 2.0 * n * k * d + 2.0 * n * d
    nbytes = 4.0 * (n * d + n + 2 * k * d)
    return _bound(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def phase_small(dev):
    """Short first calls: ragged shapes, every tier and mode, and the
    kernel loop against the numpy reference."""
    results = []
    # wgmma at d <= 256 (one and many center tiles, ragged rows, 4-byte
    # copies where d is no multiple of 4), wgmma_wide above (depths no
    # multiple of 4 or of 64, one and several groups, several center
    # tiles a group at k = 2100)
    for n, d, k in ((5000, 16, 8), (3001, 37, 13), (4099, 256, 1000), (2000, 64, 300),
                    (777, 300, 70), (777, 257, 70), (1025, 300, 64), (513, 513, 129),
                    (300, 1000, 9), (1500, 300, 2100)):
        x, w, c = blobs(n, d, k, dev, seed=n)
        for mode in TIERS:
            for need_cost in (True, False):
                results.append(compare(x, w, c, mode, need_cost))
    x, _, c = blobs(5000, 16, 8, dev, seed=7, spread=6.0)
    ones = torch.ones(x.shape[0], device=dev)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c, 30, 1e-4)
    c2, it2, cost2 = lloyd_np(x.double().cpu().numpy(), c.double().cpu().numpy(), 30, 1e-4)
    check(it1 == it2, f"small loop: {it1} iterations, numpy reference {it2}")
    check(np.allclose(c1.cpu().numpy(), c2, atol=1e-4), "small loop: centers off")
    check(abs(float(cost1) - cost2) <= 1e-4 * cost2, "small loop: cost off")
    emit("small", {"variants": len(results), "loop_iters": it1,
                   "worst_sums_rel_err": max(r["sums_rel_err"] for r in results)})


def count_sass_by_function(lib, opcode):
    """Instructions of ``opcode`` in each kernel function of a built
    library's SASS, by mangled name, from the toolkit's ``cuobjdump``
    beside nvcc."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr.strip()[:500]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            fn = m.group(1)
            counts.setdefault(fn, 0)
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def wide_hgmma():
    """HGMMA instructions of K1's library by assignment route: the d <= 256
    route's kernels, the wide route's; fails when the wide route has
    none."""
    lib = _build.library_path(kmeans_kernel.KERNEL)
    by_fn = count_sass_by_function(lib, "HGMMA")
    out = {"wgmma": sum(v for f, v in by_fn.items() if "assign_wgmma_kernel" in f),
           "wgmma_wide": sum(v for f, v in by_fn.items() if "assign_wide_kernel" in f)}
    print(f"sass {lib.name} HGMMA by route: {out}", flush=True)
    check(out["wgmma_wide"] > 0, "the wide route's kernels hold no HGMMA instruction")
    return out


def wide_fit(cfg, dev):
    """The wide table's K-Means fit through the entry point, counts zeroed
    just before (K1 = num_iter + 1 on the wide route), held against the
    same fit with its Lloyd loop on the plain version (the same k-means||
    init); the kernel loop against the plain-version loop from centers
    near the blob centers; predict and compute_cost on the model."""
    n, d = cfg["fit"]
    k, max_iter = cfg["k"], cfg["max_iter"]
    x, _, c_near = blobs(n, d, k, dev, seed=35)

    def fit():
        return KMeans(k=k, max_iter=max_iter, tol=1e-4, init_mode="k-means||", seed=0,
                      device=str(dev)).fit(x)

    sync(dev)
    t0 = time.perf_counter()
    model, launches = counted_fit(fit, kmeans_kernel.LAUNCHES)
    wall = time.perf_counter() - t0
    s = model.summary
    expect = s.num_iter + 1 if dev.type == "cuda" else 0
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"wide fit: K1 launched {launches[kmeans_kernel.KERNEL]} times, expected "
          f"num_iter + 1 = {expect}")
    check(kmeans_kernel.assign_route(d) == "wgmma_wide", f"wide fit: route at d = {d}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (k, d)
          and np.all(np.isfinite(model.cluster_centers_)), "wide fit: non-finite or misshapen")
    labels = model.predict(x)
    check(labels.dtype == np.int32 and labels.shape == (n,) and labels.min() >= 0
          and labels.max() < k, f"wide predict: {labels.dtype}, {labels.shape}")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"wide compute_cost {cost} vs training cost {s.training_cost}")
    # the same fit (the same k-means|| init: it launches no K1) with the
    # Lloyd loop on the plain version
    real = kmeans_kernel.lloyd_accumulate
    kmeans_kernel.lloyd_accumulate = _plain_k1
    try:
        ref = fit()
    finally:
        kmeans_kernel.lloyd_accumulate = real
    # from k-means|| seeds some blobs hold two centers, whose rows split at
    # near-ties: the two fits may stop an iteration apart (the move test
    # passes when no label changes), so the fits are held by their cost and
    # the loops from one center a blob by iterations, centers and cost
    cost_err = abs(s.training_cost - ref.summary.training_cost) / ref.summary.training_cost
    center_err = float(np.max(np.abs(model.cluster_centers_ - ref.cluster_centers_))
                       / np.max(np.abs(ref.cluster_centers_)))
    check(cost_err <= 1e-4, f"wide fit vs the plain-version fit: cost {cost_err:.3g} "
          f"({s.num_iter} vs {ref.summary.num_iter} iterations)")
    ones = torch.ones(n, device=dev)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c_near, max_iter, 1e-4)

    def plain(centers, final):
        return kmeans_kernel.lloyd_accumulate_plain(x, ones, centers, "highest", final)

    c2, it2, cost2, _ = kmeans_ops._lloyd_loop(plain, lambda m: m, c_near, max_iter, 1e-4)
    loop_cost_err = abs(float(cost1) - float(cost2)) / float(cost2)
    loop_center_err = _rel_err(c1, c2)
    check(it1 == it2 and loop_cost_err <= 1e-4 and loop_center_err <= 1e-4,
          f"wide loop parity: {it1} vs {it2} iterations, cost {loop_cost_err:.3g}, "
          f"centers {loop_center_err:.3g}")
    return {"shape": [n, d], "k": k, "num_iter": s.num_iter, "wall_s": wall,
            "phases_s": s.timings.as_dict(), "launches": launches,
            "iters_per_s": s.num_iter / max(s.timings.as_dict()["lloyd_loop"], 1e-12),
            "training_cost": s.training_cost, "compute_cost": cost,
            "predict_dtype": str(labels.dtype),
            "vs_plain_fit": {"num_iter": ref.summary.num_iter, "cost_rel_err": cost_err,
                             "centers_rel_err": center_err},
            "loop_parity": {"n_iter": it1, "plain_n_iter": it2, "cost_rel_err": loop_cost_err,
                            "centers_rel_err": loop_center_err}}


def phase_kmeans_wide(cfg, dev, smi):
    """Phase 35 (module docstring): K1 above d = 256."""
    t_phase = time.perf_counter()
    reps = 5 if dev.type == "cuda" else 1
    hgmma = wide_hgmma() if dev.type == "cuda" else None
    k = cfg["k"]
    variants = []
    for n, d in cfg["shapes"]:
        x, w, c = blobs(n, d, k, dev, seed=d)
        route = kmeans_kernel.assign_route(d)
        check(route == "wgmma_wide", f"d = {d} takes the {route} route")
        for mode in TIERS:
            if mode == "highest":
                a, b = x, c.T
            else:
                a, b = x.to(torch.bfloat16), c.T.contiguous().to(torch.bfloat16)
            for need_cost in (False, True):
                v = compare(x, w, c, mode, need_cost)
                v.update(shape=[n, d], k=k, route=route)
                v["ms"] = time_ms(lambda: run_kernel(x, w, c, mode, need_cost), dev, reps)
                v["plain_ms"] = time_ms(
                    lambda: kmeans_kernel.lloyd_accumulate_plain(x, w, c, mode, need_cost),
                    dev, 1)
                v["bound_ms"], v["bound_by"] = bound(n, d, k, mode)
                v["library_ms"] = time_ms(lambda: torch.matmul(a, b), dev, reps)
                v["library_call"] = (f"torch.matmul(x, c.T) in "
                                     f"{'f32' if mode == 'highest' else 'bf16'}: the cross term")
                variants.append(v)
                emit("wide_variant", {**v, "card": smi})
            del a, b
        del x, w, c
    fit = wide_fit(cfg, dev)
    res = {"variants": variants, "fit": fit, "hgmma": hgmma,
           "wall_s": time.perf_counter() - t_phase, "card": smi}
    emit("kmeans_wide", {key: res[key] for key in ("fit", "hgmma", "wall_s", "card")})
    last = cfg["shapes"][-1]
    loop = [v for v in variants if v["shape"] == list(last) and not v["need_cost"]]
    print(f"kmeans_wide loop pass at {last[0]} x {last[1]}: " + "; ".join(
        f"{v['mode']} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}, matmul {v['library_ms']:.3f})"
        for v in loop) + f"; fit {fit['wall_s']:.2f} s, {fit['num_iter']} iterations, K1 "
        f"{fit['launches'][kmeans_kernel.KERNEL]}; phase {res['wall_s']:.1f} s | {smi}",
        flush=True)
    return res


def phase_kernels(x, w, c, dev, reps):
    n, d = x.shape
    k = c.shape[0]
    variants = []
    for mode in TIERS:
        for need_cost in (False, True):
            v = compare(x, w, c, mode, need_cost)
            v["route"] = kmeans_kernel.assign_route(d)
            v["ms"] = time_ms(lambda: run_kernel(x, w, c, mode, need_cost), dev, reps)
            v["plain_ms"] = time_ms(
                lambda: kmeans_kernel.lloyd_accumulate_plain(x, w, c, mode, need_cost),
                dev, max(1, reps // 4),
            )
            v["bound_ms"], v["bound_by"] = bound(n, d, k, mode)
            if mode == "highest":
                a, b = x, c.T
            else:
                a, b = x.to(torch.bfloat16), c.T.contiguous().to(torch.bfloat16)
            v["library_ms"] = time_ms(lambda: torch.matmul(a, b), dev, reps)
            variants.append(v)
            emit("variant", v)
    return variants


def kernel_breakdown(x, w, c, dev, mode):
    """Device time per CUDA kernel of one wrapper call (loop mode) at a
    tier, from torch.profiler over three calls; empty where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    run_kernel(x, w, c, mode, False)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run_kernel(x, w, c, mode, False)
        sync(dev)
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        m = re.search(r"(\w+_kernel)(<[^>]*>)?|Memset", ev.key)
        if us and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / 3e3
    emit("breakdown_ms", {"mode": mode, "kernels": out})
    return out


def phase_last_card(dev):
    """With more than one card: K1, K2, K3 and K4 on the last card (each
    library sets that card as its device itself: its statically linked
    runtime does not see the wrapper's current device) against their
    plain versions, at the small phase's tolerances."""
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if count < 2:
        return None
    last = torch.device("cuda", count - 1)
    x, w, c = blobs(1 << 16, 256, 1000, last, seed=9)
    v = compare(x, w, c, "highest", True)
    v["device"] = str(last)
    g = torch.Generator(device=last)
    g.manual_seed(13)
    xp = torch.randn((1 << 16, 128), generator=g, device=last) * 2.0 + 1.5
    mask = torch.ones(xp.shape[0], device=last)
    _, cs, _ = pca_kernel.pca_moments(xp, mask, None, "highest", need_gram=False)
    _, cs_p, _ = pca_kernel.pca_moments_plain(xp, mask, None, "highest", need_gram=False)
    mean = cs / xp.shape[0]
    gk, _, _ = pca_kernel.pca_moments(xp, mask, mean, "highest", need_sums=False)
    gp, _, _ = pca_kernel.pca_moments_plain(xp, mask, mean, "highest", need_sums=False)
    v["pca_moments"] = {"colsum_rel_err": _rel_err(cs, cs_p), "gram_rel_err": _rel_err(gk, gp)}
    check(v["pca_moments"]["colsum_rel_err"] <= PCA_SUM_RTOL
          and v["pca_moments"]["gram_rel_err"] <= PCA_GRAM_RTOL["highest"],
          f"pca_moments on {last}: {v['pca_moments']}")
    r, n = 10, 20_000
    y = torch.randn((n, 3 * r, r), generator=g, device=last)
    a = y.transpose(1, 2) @ y / (3 * r)
    b = torch.randn((n, r), generator=g, device=last)
    n_reg = torch.randint(0, 3, (n,), generator=g, device=last).float()
    f = torch.randn((4099, r), generator=g, device=last)
    gram = als_kernel.factor_gram(f)
    gram_err = _rel_err(gram, als_kernel.factor_gram_plain(f))
    w_k = als_kernel.solve_normal_eq(a, b, n_reg, 0.1, gram)
    w_p = als_kernel.solve_plain(a, b, n_reg, 0.1, gram)
    v["als_solve"] = {"bit_equal": bool(torch.equal(w_k, w_p)), "rel_err": _rel_err(w_k, w_p)}
    v["als_factor_gram"] = {"rel_err": gram_err, "bit_symmetric": bool(torch.equal(gram, gram.T))}
    check(v["als_solve"]["bit_equal"], f"als_solve on {last}: {v['als_solve']}")
    check(gram_err <= 1e-5 and v["als_factor_gram"]["bit_symmetric"],
          f"als_factor_gram on {last}: {v['als_factor_gram']}")
    emit("last_card", v)
    return v


def phase_fit(x, dev, cfg, max_iter):
    kmeans_kernel.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = KMeans(k=cfg["k"], max_iter=max_iter, tol=1e-4, init_mode="k-means||",
                   seed=0, device=str(dev)).fit(x)
    wall = time.perf_counter() - t0
    launches = dict(kmeans_kernel.LAUNCHES)
    s = model.summary
    expect = s.num_iter + 1 if dev.type == "cuda" else 0
    check(s.kernels == launches, f"summary kernels {s.kernels} != counters {launches}")
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"kmeans_accumulate launched {launches[kmeans_kernel.KERNEL]} times, "
          f"expected num_iter + 1 = {expect}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (cfg["k"], cfg["d"]),
          "fit: non-finite cost or wrong center shape")
    check(np.all(np.isfinite(model.cluster_centers_)), "fit: non-finite centers")
    check(abs(float(np.sum(s.cluster_sizes)) - x.shape[0]) <= 1e-3 * x.shape[0],
          "fit: cluster sizes do not add up to the rows")
    phases = s.timings.as_dict()
    fit = {
        "num_iter": s.num_iter, "training_cost": s.training_cost,
        "wall_s": wall, "phases_s": phases,
        "iters_per_s": s.num_iter / phases["lloyd_loop"],
        "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
    }
    labels = model.predict(x)
    check(labels.shape == (x.shape[0],) and labels.min() >= 0 and labels.max() < cfg["k"],
          "predict: labels out of range")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"compute_cost {cost} vs training cost {s.training_cost}")
    fit["compute_cost"] = cost
    emit("fit", fit)
    return fit, model


def phase_loop_parity(x, dev, cfg, max_iter):
    """Kernel loop and plain-version loop from the same initial centers."""
    c0 = torch.as_tensor(
        kmeans_ops.init_random(x, x.shape[0], cfg["k"], seed=1), device=dev
    ).contiguous()
    ones = torch.ones(x.shape[0], device=dev)
    _, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0, max_iter, 1e-4)

    def plain(centers, final):
        if final:
            return kmeans_kernel.lloyd_accumulate_plain(x, ones, centers, "highest", True)
        return kmeans_kernel.lloyd_accumulate_plain(x, ones, centers, "highest", False)

    _, it2, cost2, _ = kmeans_ops._lloyd_loop(plain, lambda m: m, c0, max_iter, 1e-4)
    err = abs(float(cost1) - float(cost2)) / float(cost2)
    check(it1 == it2, f"loop parity: kernel {it1} iterations, plain {it2}")
    check(err <= 1e-4, f"loop parity: cost rel err {err:.3g}")
    emit("loop_parity", {"n_iter": it1, "cost_rel_err": err})


def device_breakdown(fn, dev, top=12):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    the ``top`` kernels in ms, the device's busy total and the host wall
    of the profiled call; None on the CPU or where the profiler records
    no device time."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    by = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by[ev.key[:80]] = by.get(ev.key[:80], 0.0) + us / 1e3
    if not by:
        return None
    busy = sum(by.values())
    ranked = dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])
    return {"kernels_ms": ranked, "busy_ms": busy, "wall_ms": wall,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def mesh_breakdown(fn, devs):
    """Device time of one call of ``fn`` per card of a mesh
    (torch.profiler's kernel events by device index, from the second of
    two profiled calls: the first starts the tracer): busy ms and
    kernels on each card, and its idle share of the call's wall without
    the profiler (``wall_ms``, the host clock between syncs of every
    card; the profiled call's own wall beside it); None on the CPU or
    where the profiler records no kernel."""
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    if not cards:
        return None
    from torch.profiler import ProfilerActivity, profile

    wall = time_ms_all(fn, devs, reps=3)
    for _ in range(2):
        sync_all(devs)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync_all(devs)
        profiled = (time.perf_counter() - t0) * 1e3
    busy, kernels = {}, {}
    for ev in prof.events():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        busy[ev.device_index] = busy.get(ev.device_index, 0.0) + ev.time_range.elapsed_us() / 1e3
        kernels[ev.device_index] = kernels.get(ev.device_index, 0) + 1
    if not busy:
        return None
    return {"wall_ms": wall, "profiled_wall_ms": profiled, "cards": {
        f"cuda:{c}": {"busy_ms": busy.get(c, 0.0), "kernels": kernels.get(c, 0),
                      "idle_share": max(0.0, 1.0 - busy.get(c, 0.0) / wall)} for c in cards}}


def profile_calls(fn, dev, reps=10, tries=6):
    """The CUDA kernels that ``reps`` calls of ``fn`` launch, by
    torch.profiler, after a warm call (which builds the kernel and fills
    the wrapper's caches): ``(names of one call's kernels, device ms per
    call)``; None on the CPU.  A profile that records no kernel is taken
    again, up to ``tries`` times (the tracer has dropped a session's
    kernels on the card, three sessions in a row once)."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    evs = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync(dev)
        evs = [ev for ev in prof.events() if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        if evs:
            break
    per_call = round(len(evs) / reps)
    names = sorted({ev.name[:80] for ev in evs})
    mean_us = sum(ev.time_range.elapsed_us() for ev in evs) / max(1, len(evs))
    return [names[i % len(names)] for i in range(per_call)], mean_us * per_call / 1e3


def _bound(t_ops, t_bytes):
    """(bound ms, what bounds it) from the two least times in seconds."""
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sign_err(c, ref):
    """Largest column difference of two component matrices, each column
    compared up to its sign."""
    return float(max((min(np.max(np.abs(c[:, j] - ref[:, j])),
                          np.max(np.abs(c[:, j] + ref[:, j])))
                      for j in range(c.shape[1])), default=0.0))


# -- PCA ----------------------------------------------------------------------

def pca_data(n, d, dev, seed):
    """Rows with a decaying spectrum (variances 100 * 0.7225^j along a
    random orthogonal basis) around a mean of 3, made on the device."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=torch.float32)
    z = torch.randn((n, d), generator=g, device=dev) * scale
    return (z @ q.T + 3.0).contiguous()


def pca_bound(n, d, mode, need_gram):
    """Least time of one moments pass: x, mask and mean read once, the
    outputs written once; the symmetric Gram's n d (d + 1) operations
    (its d (d + 1) / 2 distinct entries, 2 n each) at the tensor-core
    peak, as bf16 products: highest six (an f32-accurate split, the
    fastest f32-accurate product on this card, as K1's bound counts it),
    high three, default one; the sums' 2 n d on FP32."""
    nbytes = 4.0 * (n * d + n + d + (d * d if need_gram else d + 1))
    if not need_gram:
        return _bound(2.0 * n * d / PEAK_FP32, nbytes / PEAK_BYTES)
    passes = {"highest": 6, "high": 3, "default": 1}[mode]
    return _bound(passes * float(n) * d * (d + 1) / PEAK_BF16, nbytes / PEAK_BYTES)


def pca_fp32_pipe_ms(n, d):
    """The Gram's n d (d + 1) operations on the FP32 pipe (67 TFLOP/s):
    highest's bound while its products were f32 FMAs."""
    return float(n) * d * (d + 1) / PEAK_FP32 * 1e3


def pca_variants(x, mask, mode, dev, reps):
    """Both passes of the moments kernel at one tier against the plain
    version: errors, determinism, times, bound, yardstick."""
    n, d = x.shape
    tag = f"pca {n}x{d} {mode}"
    k = pca_kernel.pca_moments
    plain = pca_kernel.pca_moments_plain
    _, cs, cnt = k(x, mask, None, mode, need_gram=False)
    _, cs2, cnt2 = k(x, mask, None, mode, need_gram=False)
    _, cs_p, cnt_p = plain(x, mask, None, mode, need_gram=False)
    same = torch.equal(cs, cs2) and torch.equal(cnt, cnt2)
    err = max(_rel_err(cs, cs_p), _rel_err(cnt.reshape(1), cnt_p.reshape(1)))
    check(same, f"{tag} mean pass: two launches differ")
    check(err <= PCA_SUM_RTOL, f"{tag} mean pass: colsum/count rel err {err:.3g}")
    mean_v = {
        "pass": "mean", "mode": mode, "shape": [n, d], "rel_err": err,
        "max_abs_err": float(torch.max(torch.abs(cs - cs_p))), "deterministic": same,
        "ms": time_ms(lambda: k(x, mask, None, mode, need_gram=False), dev, reps),
        "plain_ms": time_ms(lambda: plain(x, mask, None, mode, need_gram=False), dev, reps),
        "library_ms": time_ms(lambda: torch.sum(x, dim=0), dev, reps),
        "library_call": "torch.sum(x, dim=0)",
    }
    mean_v["bound_ms"], mean_v["bound_by"] = pca_bound(n, d, mode, False)
    emit("pca_variant", mean_v)

    mean = cs / float(n)
    g, _, _ = k(x, mask, mean, mode, need_sums=False)
    g2, _, _ = k(x, mask, mean, mode, need_sums=False)
    g_p, _, _ = plain(x, mask, mean, mode, need_sums=False)
    same = torch.equal(g, g2)
    err = _rel_err(g, g_p)
    check(same, f"{tag} Gram pass: two launches differ")
    check(dev.type != "cuda" or torch.equal(g, g.T), f"{tag} Gram pass: not bit-symmetric")
    rtol = pca_gram_rtol(mode, n, d)
    check(err <= rtol, f"{tag} Gram pass: rel err {err:.3g} over {rtol:.3g}")
    err64 = _rel_err(g.double(), gram_f64(x, mask, mean)) if mode == "highest" else None
    check(err64 is None or err64 <= PCA_GRAM_F64_RTOL,
          f"{tag} Gram pass: rel err {err64} against the float64 Gram")
    route = _gram.pca_gram_route(mode, d)
    check(d < _gram.WGMMA_MIN_D or route == "wgmma", f"{tag} Gram pass: route {route}")
    xc = x - mean
    a = xc if mode == "highest" else xc.to(torch.bfloat16)
    gram_v = {
        "pass": "gram", "mode": mode, "shape": [n, d], "rel_err": err, "rtol": rtol,
        "rel_err_f64": err64, "route": route,
        "max_abs_err": float(torch.max(torch.abs(g - g_p))), "deterministic": same,
        "ms": time_ms(lambda: k(x, mask, mean, mode, need_sums=False), dev, reps),
        "plain_ms": time_ms(lambda: plain(x, mask, mean, mode, need_sums=False), dev, reps),
        "library_ms": time_ms(lambda: torch.matmul(a.T, a), dev, reps),
        "library_call": "torch.matmul(xc.T, xc), " + ("f32, TF32 off" if mode == "highest" else "bf16"),
    }
    gram_v["bound_ms"], gram_v["bound_by"] = pca_bound(n, d, mode, True)
    if mode == "highest":
        gram_v["fp32_pipe_ms"] = pca_fp32_pipe_ms(n, d)
    emit("pca_variant", gram_v)
    return [mean_v, gram_v]


def phase_pca_kernels(cfg, dev, reps):
    variants = []
    for n, d in cfg["shapes"]:
        x = pca_data(n, d, dev, seed=d)
        mask = torch.ones(n, device=dev)
        for mode in TIERS:
            variants += pca_variants(x, mask, mode, dev, reps)
        del x, mask
    return variants


def phase_pca_fit(cfg, dev):
    """The PCA path, counts zeroed just before; held against a fit
    through the plain version on the same device."""
    (n, d), k = cfg["shapes"][0], cfg["k"]
    x = pca_data(n, d, dev, seed=d)
    pca_kernel.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = PCA(k=k, device=str(dev)).fit(x)
    wall = time.perf_counter() - t0
    launches = dict(pca_kernel.LAUNCHES)
    s = model.summary
    check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
    expect = 2 if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == expect,
          f"pca_moments launched {launches[pca_kernel.KERNEL]} times, expected {expect}")
    cov_p, _ = pca_ops.covariance(x, torch.ones(n, device=dev), n, "highest",
                                  moments=pca_kernel.pca_moments_plain)
    vals_p, vecs_p = pca_ops.eigh_descending(cov_p)
    vals_p = vals_p.cpu().numpy()
    ratio_p = vals_p[:k] / float(vals_p.sum())
    keep = ratio_p > 1e-5
    comp_err = sign_err(model.components_[:, keep], vecs_p[:, :k].cpu().numpy()[:, keep])
    ratio_err = float(np.max(np.abs(model.explained_variance_ - ratio_p)))
    check(comp_err <= PCA_FIT_TOL and ratio_err <= PCA_FIT_TOL,
          f"pca fit vs plain fit: components {comp_err:.3g}, ratios {ratio_err:.3g}")
    proj = model.transform(x[:4096])
    ref = (x[:4096] @ torch.as_tensor(model.components_, device=dev)).cpu().numpy()
    check(proj.shape == (min(4096, n), k) and np.all(np.isfinite(proj)), "transform: bad output")
    check(np.allclose(proj, ref, rtol=1e-5, atol=1e-4), "transform differs from x @ components")
    phases = s["timings"].as_dict()
    breakdown = device_breakdown(lambda: PCA(k=k, device=str(dev)).fit(x), dev)
    fit = {
        "shape": [n, d], "k": k, "wall_s": wall, "phases_s": phases,
        "breakdown": breakdown,
        "launches": launches, "components_err": comp_err, "ratio_err": ratio_err,
        "ratios": [float(v) for v in model.explained_variance_],
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
    }
    emit("pca_fit", fit)
    return fit


# -- ALS ----------------------------------------------------------------------

def als_data(cfg):
    """Ratings shaped like the JAX bench's ML-25M case, from numpy seeds:
    uniform users, zipf(1.3) items, ratings in [1, 5)."""
    rng = np.random.default_rng(3)
    users = rng.integers(cfg["n_users"], size=cfg["nnz"]).astype(np.int32)
    items = (np.random.default_rng(4).zipf(1.3, size=cfg["nnz"])
             % cfg["n_items"]).astype(np.int32)
    ratings = (rng.random(cfg["nnz"]) * 4 + 1).astype(np.float32)
    return users, items, ratings


def solve_bound(n, r, gram):
    """Least time of the solve: per system the lower triangle of A
    (r (r + 1) / 2 floats, all the solve reads), b and n_reg read once
    and the factors written once, plus the Gram's lower triangle;
    Cholesky and substitutions at the FP32 rate."""
    tri = r * (r + 1) // 2
    nbytes = 4.0 * (n * (tri + 2 * r + 1) + (tri if gram else 0))
    return _bound(n * (r ** 3 / 3.0 + 2.0 * r * r + r) / PEAK_FP32, nbytes / PEAK_BYTES)


def gram_bound(n, r):
    """F read once and the (r, r) Gram written once; the symmetric
    Gram's n r (r + 1) operations on FP32."""
    return _bound(float(n) * r * (r + 1) / PEAK_FP32, 4.0 * (n * r + r * r) / PEAK_BYTES)


def k4_worker(argv) -> int:
    """``--k4-worker N R1,R2,...``: K4's kernels a call and device ms
    (torch.profiler, :func:`profile_calls`) on random (N, r) factors, and
    its device ms on the same grid over 8 rows a block (the launch and the
    in-kernel grid sum, next to no rows to read), in a fresh process: this
    process's torch.profiler sessions stop recording kernels after the
    earlier phases' sessions (the kernels it launches are its own, the
    build it loads is this run's; K4's launches and time follow the shape,
    not the values).  Prints one ``K4_RESULT`` line."""
    n, ranks = int(argv[0]), [int(r) for r in argv[1].split(",")]
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    out = {}
    for r in ranks:
        xf = torch.randn((n, r), generator=g, device=dev) / r ** 0.5
        launched, device = profile_calls(lambda: als_kernel.factor_gram(xf), dev)
        few = xf[:8 * als_kernel.factor_gram_geometry(n, r).blocks].contiguous()
        out[str(r)] = {"launched": launched, "device_ms": device,
                       "fixed_ms": profile_calls(lambda: als_kernel.factor_gram(few), dev)[1]}
    print("K4_RESULT " + json.dumps(out), flush=True)
    return 0


def k4_profiles(n, ranks):
    """:func:`k4_worker`'s results, run in a child process."""
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--k4-worker", str(n),
                        ",".join(str(r) for r in ranks)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                       timeout=MP_TIMEOUT_S)
    for line in p.stdout.splitlines():
        if not line.startswith("K4_RESULT "):
            print(line, flush=True)
    check(p.returncode == 0, f"als_factor_gram: the profiling child exited {p.returncode}")
    got = [ln for ln in p.stdout.splitlines() if ln.startswith("K4_RESULT ")]
    check(bool(got), "als_factor_gram: the profiling child printed no result")
    return json.loads(got[-1][len("K4_RESULT "):])


def phase_als_kernels(cfg, data, dev, reps):
    """The solve and factor-Gram kernels on the user side's moments,
    built on the device from random item factors."""
    users, items, ratings = data
    n_users, n_items, reg = cfg["n_users"], cfg["n_items"], cfg["reg"]
    k4 = k4_profiles(n_users, cfg["ranks"]) if dev.type == "cuda" else {}
    by_user = als_ops.build_grouped_edges(users, items, ratings, n_users)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    solves, grams = [], []
    for r in cfg["ranks"]:
        side = als_ops.prepare_grouped(*by_user, n_users, r, dev)
        y = torch.randn((n_items, r), generator=g, device=dev) / r ** 0.5
        xf = torch.randn((n_users, r), generator=g, device=dev) / r ** 0.5
        a, b, n_reg = side.partials(y, cfg["alpha"], True)
        valid = n_reg > 0
        for gm in (als_kernel.factor_gram_plain(y), None):
            tag = f"als_solve r={r} gram={gm is not None}"
            w = als_kernel.solve_normal_eq(a, b, n_reg, reg, gm)
            same = torch.equal(w, als_kernel.solve_normal_eq(a, b, n_reg, reg, gm))
            w_p = als_kernel.solve_plain(a, b, n_reg, reg, gm)
            err = _rel_err(w[valid], w_p[valid])
            bit_equal = torch.equal(w[valid], w_p[valid])
            check(same, f"{tag}: two launches differ")
            check(bool(torch.all(w[~valid] == 0)), f"{tag}: rows with n_reg = 0 are not 0")
            check(bool(torch.all(torch.isfinite(w))) and err <= SOLVE_RTOL,
                  f"{tag}: rel err {err:.3g}")
            check(bit_equal, f"{tag}: not bit-equal to the plain version (rel err {err:.3g})")
            v = {
                "r": r, "gram": gm is not None, "n": int(b.shape[0]),
                "group": als_kernel.solve_group(r),
                "empty_rows": int((~valid).sum()), "rel_err": err, "bit_equal": bit_equal,
                "max_abs_err": float(torch.max(torch.abs(w - w_p))), "deterministic": same,
                "ms": time_ms(lambda: als_kernel.solve_normal_eq(a, b, n_reg, reg, gm), dev, reps),
                "plain_ms": time_ms(lambda: als_kernel.solve_plain(a, b, n_reg, reg, gm), dev, 2),
                "library_call": "torch.linalg.solve(A, b) on the assembled A",
            }
            v["bound_ms"], v["bound_by"] = solve_bound(int(b.shape[0]), r, gm is not None)
            full = a + reg * n_reg[:, None, None] * torch.eye(r, device=dev)[None]
            if gm is not None:
                full = gm[None] + full
            v["library_ms"] = time_ms(lambda: torch.linalg.solve(full, b), dev, reps)
            v["device_ms"] = (profile_calls(
                lambda: als_kernel.solve_normal_eq(a, b, n_reg, reg, gm), dev) or (None, None))[1]
            del full
            solves.append(v)
            emit("als_solve_variant", v)
        gk = als_kernel.factor_gram(xf)
        same = torch.equal(gk, als_kernel.factor_gram(xf))
        gp = als_kernel.factor_gram_plain(xf)
        err = _rel_err(gk, gp)
        check(same and (dev.type != "cuda" or torch.equal(gk, gk.T)),
              f"als_factor_gram r={r}: not deterministic or not bit-symmetric")
        check(err <= 1e-5, f"als_factor_gram r={r}: rel err {err:.3g}")
        prof = k4.get(str(r), {})
        launched, device, fixed = prof.get("launched"), prof.get("device_ms"), prof.get("fixed_ms")
        check(launched is None or len(launched) == 1,
              f"als_factor_gram r={r}: one call launched {launched}, expected one kernel")
        v = {
            "r": r, "n": n_users, "rel_err": err, "deterministic": same,
            "geometry": als_kernel.factor_gram_geometry(n_users, r)._asdict(),
            "kernels_per_call": None if launched is None else len(launched),
            "kernel_names": launched, "device_ms": device,
            "fixed_device_ms": fixed,
            "fixed_rows": min(n_users, 8 * als_kernel.factor_gram_geometry(n_users, r).blocks),
            "max_abs_err": float(torch.max(torch.abs(gk - gp))),
            "ms": time_ms(lambda: als_kernel.factor_gram(xf), dev, reps),
            "plain_ms": time_ms(lambda: als_kernel.factor_gram_plain(xf), dev, reps),
            "library_ms": time_ms(lambda: torch.matmul(xf.T, xf), dev, reps),
            "library_call": "torch.matmul(F.T, F), f32, TF32 off",
        }
        v["bound_ms"], v["bound_by"] = gram_bound(n_users, r)
        grams.append(v)
        emit("als_gram_variant", v)
        del side, a, b, n_reg
    return solves, grams


def phase_als_fit(cfg, data, dev):
    """The ALS path, counts zeroed just before; held against a fit
    through the plain versions from the same initial factors."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["rank"], cfg["max_iter"]
    on_card = dev.type == "cuda"
    als_kernel.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                alpha=cfg["alpha"], seed=0, device=str(dev)).fit(
        users, items, ratings, n_users, n_items)
    wall = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    s = model.summary
    check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
    expect = 2 * it if on_card else 0
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect},
          f"ALS launches {launches}, expected {expect} of each")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None

    user_side, item_side = als_ops.prepare_sides(
        s["als_kernel"] == "grouped", users, items, ratings, n_users, n_items, r, dev)
    x0 = torch.from_numpy(als_np.init_factors(n_users, r, 0)).to(dev)
    y0 = torch.from_numpy(als_np.init_factors(n_items, r, 1)).to(dev)
    xp, yp = als_ops.run_sides(user_side, item_side, x0, y0, it, cfg["reg"], cfg["alpha"],
                               True, solve=als_kernel.solve_plain,
                               gram=als_kernel.factor_gram_plain)
    # one iteration of the kernel loop, profiled (after the fit's counts),
    # with the moments through concatenated operands and with the
    # copy-free ones
    iteration = {}
    for name, partials in (("concat_moments", partials_with_copies),
                           ("copy_free_moments", als_ops.GroupedSide.partials)):
        saved, als_ops.GroupedSide.partials = als_ops.GroupedSide.partials, partials
        try:
            def one_iteration():
                return als_ops.run_sides(user_side, item_side, x0, y0, 1, cfg["reg"],
                                         cfg["alpha"], True)
            got = one_iteration()
            calls = profile_calls(one_iteration, dev, reps=3)
            recorded = calls is not None and len(calls[0]) > 0
            iteration[name] = {
                "device_ms": calls[1] if recorded else None,
                "kernels_per_iteration": len(calls[0]) if recorded else None,
                "ms": time_ms(one_iteration, dev, 3),
                "breakdown": device_breakdown(one_iteration, dev),
            }
        finally:
            als_ops.GroupedSide.partials = saved
        iteration.setdefault("_results", []).append(got)
    base, new = iteration.pop("_results")
    moments_err = max(_rel_err(base[0], new[0]), _rel_err(base[1], new[1]))
    check(moments_err <= 1e-4, f"one iteration, copy-free moments vs concatenated: {moments_err:.3g}")
    iteration["rel_err_between"] = moments_err
    breakdown = iteration["copy_free_moments"]["breakdown"]
    del user_side, item_side
    u = torch.as_tensor(users.astype(np.int64), device=dev)
    i = torch.as_tensor(items.astype(np.int64), device=dev)
    pred = torch.as_tensor(model.predict(users, items), device=dev)
    pred_p = als_ops.predict_pairs(xp, yp, u, i)
    err = float(torch.linalg.vector_norm(pred - pred_p) / torch.linalg.vector_norm(pred_p))
    check(bool(torch.all(torch.isfinite(pred))), "ALS fit: non-finite predictions")
    check(err <= ALS_FIT_RTOL, f"ALS fit vs plain fit: prediction rel err {err:.3g}")
    del u, i, pred, pred_p, xp, yp

    als_kernel.reset_launches()
    explicit = ALS(rank=r, max_iter=cfg["explicit_iter"], reg_param=cfg["reg"], seed=0,
                   device=str(dev)).fit(users, items, ratings, n_users, n_items)
    want = {als_kernel.SOLVE: 2 * cfg["explicit_iter"] if on_card else 0, als_kernel.GRAM: 0}
    check(dict(als_kernel.LAUNCHES) == want,
          f"explicit ALS launches {als_kernel.LAUNCHES}, expected {want}")
    check(np.all(np.isfinite(explicit.user_factors_)), "explicit ALS: non-finite factors")

    q = np.arange(min(4096, n_users))
    ids, scores = model.recommend_for_users(q, 10, with_scores=True)
    check(ids.shape == (len(q), 10) and ids.min() >= 0 and ids.max() < n_items,
          "recommend: ids out of range")
    check(bool(np.all(np.diff(scores, axis=1) <= 0)), "recommend: scores not descending")
    xq = torch.as_tensor(model.user_factors_[q[:64]], device=dev)
    full = xq @ torch.as_tensor(model.item_factors_, device=dev).T
    ref = torch.sort(full, dim=1, descending=True, stable=True).indices[:, :10]
    check(np.array_equal(ids[:64], ref.cpu().numpy()), "recommend: ids differ from a full sort")

    phases = s["timings"].as_dict()
    fit = {
        "n_users": n_users, "n_items": n_items, "nnz": len(users), "rank": r,
        "max_iter": it, "layout": s["als_kernel"], "solve_kernel": s["solve_kernel"],
        "wall_s": wall, "phases_s": phases,
        "iters_per_s": it / phases["als_iterations"], "launches": launches,
        "pred_rel_err_vs_plain": err, "peak_mem_gb": peak, "iteration_breakdown": breakdown,
        "iteration_moments": iteration,
        "table_convert_split_s": {
            "grouped_build": phases.get("grouped_build", 0.0),
            "rest": phases["table_convert"] - phases.get("grouped_build", 0.0)},
        "explicit_phases_s": explicit.summary["timings"].as_dict(),
    }
    emit("als_fit", fit)
    return fit, model


def partials_with_copies(side, src_factors, alpha, implicit, policy="f32"):
    """``GroupedSide.partials`` with the moments in the JAX package's form,
    for the before/after device times: per block ``[Ys | 1]^T [a_w Ys |
    b_w | n_w]`` through two concatenated operands (f32), one segment sum
    of the (Gb, r+1, r+2) sheet."""
    r = src_factors.shape[1]
    m = torch.zeros((side.n_dst, r + 1, r + 2), dtype=torch.float32,
                    device=src_factors.device)
    for g0, g1, first, lengths in side.blocks:
        src_b, conf_b, valid_b = side.src_g[g0:g1], side.conf_g[g0:g1], side.valid_g[g0:g1]
        gb, p = src_b.shape
        ys = src_factors.index_select(0, src_b.reshape(-1)).reshape(gb, p, r)
        a_w, b_w, n_w = als_ops._weights(conf_b, valid_b, alpha, implicit)
        lhs = torch.cat([ys, torch.ones_like(conf_b)[..., None]], dim=2)
        rhs = torch.cat([ys * a_w[..., None], b_w[..., None], n_w[..., None]], dim=2)
        als_ops._segment_add(m, torch.einsum("gpa,gpb->gab", lhs, rhs), first, lengths)
    return m[:, :r, :r], m[:, :r, r], m[:, r, r + 1]


def phase_small_slices(dev):
    """Short first calls of the PCA and ALS kernels: small ragged shapes,
    every tier, and small fits against their numpy oracles."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    routes, gram_errs = set(), {}
    for n, d in PCA_SMALL:
        x = torch.randn((n, d), generator=g, device=dev) * 2.0 + 1.5
        mask = (torch.rand((n,), generator=g, device=dev) > 0.1).float()
        for mode in TIERS:
            _, cs, cnt = pca_kernel.pca_moments(x, mask, None, mode, need_gram=False)
            _, cs_p, cnt_p = pca_kernel.pca_moments_plain(x, mask, None, mode, need_gram=False)
            check(_rel_err(cs, cs_p) <= PCA_SUM_RTOL and float(cnt) == float(cnt_p),
                  f"small pca sums {n}x{d} {mode}")
            mean = cs / cnt
            gk, _, _ = pca_kernel.pca_moments(x, mask, mean, mode, need_sums=False)
            gk2, _, _ = pca_kernel.pca_moments(x, mask, mean, mode, need_sums=False)
            gp, _, _ = pca_kernel.pca_moments_plain(x, mask, mean, mode, need_sums=False)
            route = _gram.pca_gram_route(mode, d)
            routes.add(route)
            gram_errs[f"{n}x{d} {mode}"] = _rel_err(gk, gp)
            if mode == "highest":
                err64 = _rel_err(gk.double(), gram_f64(x, mask, mean))
                gram_errs[f"{n}x{d} highest f64"] = err64
                check(err64 <= PCA_GRAM_F64_RTOL,
                      f"small pca gram {n}x{d} highest: {err64:.3g} from the float64 Gram")
            # the kernel's Gram is bit-symmetric (the plain one need not be)
            check(_rel_err(gk, gp) <= PCA_GRAM_RTOL[mode] and torch.equal(gk, gk2)
                  and (dev.type != "cuda" or torch.equal(gk, gk.T)),
                  f"small pca gram {n}x{d} {mode} ({route}): {_rel_err(gk, gp):.3g}, "
                  f"deterministic {torch.equal(gk, gk2)}")
    for r in (1, 7, 32, 70):
        f = torch.randn((2049, r), generator=g, device=dev)
        for mode in TIERS:
            gk = als_kernel.factor_gram(f, mode)
            err = _rel_err(gk, als_kernel.factor_gram_plain(f, mode))
            check(err <= PCA_GRAM_RTOL[mode], f"small factor gram r={r} {mode}: {err:.3g}")
            check(torch.equal(gk, als_kernel.factor_gram(f, mode))
                  and (dev.type != "cuda" or torch.equal(gk, gk.T)),
                  f"small factor gram r={r} {mode}: not deterministic or not bit-symmetric")
    for r in (1, 10, 32):
        n = 777
        y = torch.randn((n, 3 * r, r), generator=g, device=dev)
        a = y.transpose(1, 2) @ y / (3 * r)
        m = torch.zeros((n, r + 1, r + 2), device=dev)
        m[:, :r, :r] = a
        m[:, :r, r] = torch.randn((n, r), generator=g, device=dev)
        m[:, r, r + 1] = torch.randint(0, 3, (n,), generator=g, device=dev).float()
        views = (m[:, :r, :r], m[:, :r, r], m[:, r, r + 1])
        gram = a[0].contiguous()
        for gm in (gram, None):
            w = als_kernel.solve_normal_eq(*views, 0.1, gm)
            w_p = als_kernel.solve_plain(*views, 0.1, gm)
            err = _rel_err(w, w_p)
            check(err <= SOLVE_RTOL, f"small solve r={r} gram={gm is not None}: {err:.3g}")
            check(torch.equal(w, w_p), f"small solve r={r} gram={gm is not None}: "
                                       "not bit-equal to the plain version")
    rng = np.random.default_rng(12)
    xs = (rng.normal(size=(3000, 12)) * (0.8 ** np.arange(12))).astype(np.float32) + 2.0
    model = PCA(k=4, device=str(dev)).fit(xs)
    comps, ratio = pca_np(xs, 4)
    check(sign_err(model.components_, comps) <= 1e-3
          and np.allclose(model.explained_variance_, ratio, atol=1e-5),
          "small PCA fit differs from the numpy oracle")
    u, i = rng.integers(60, size=900), rng.integers(40, size=900)
    rt = (rng.random(900) * 4 + 1).astype(np.float32)
    wide = als_wide_rank(dev, rng)
    for implicit in (True, False):
        model = ALS(rank=4, max_iter=4, implicit_prefs=implicit, alpha=5.0, seed=2,
                    device=str(dev)).fit(u, i, rt, 60, 40)
        xr, yr = als_np.als_np(u, i, rt, 60, 40, 4, 4, 0.1, 5.0, implicit, seed=2)
        err = np.linalg.norm(model.user_factors_ @ model.item_factors_.T - xr @ yr.T) / (
            np.linalg.norm(xr @ yr.T))
        check(err <= 1e-3, f"small ALS fit (implicit={implicit}) vs numpy oracle: {err:.3g}")
    nonneg = ALS(rank=4, max_iter=3, implicit_prefs=True, alpha=5.0, seed=2, nonnegative=True,
                 device=str(dev)).fit(u, i, rt, 60, 40)
    xn, yn = als_np.als_np(u, i, rt, 60, 40, 4, 3, 0.1, 5.0, True, seed=2, nonnegative=True)
    nn_err = max(float(np.max(np.abs(nonneg.user_factors_ - xn))),
                 float(np.max(np.abs(nonneg.item_factors_ - yn))))
    check(bool(np.all(nonneg.user_factors_ >= 0) and np.all(nonneg.item_factors_ >= 0))
          and nn_err <= 1e-6 and nonneg.summary["accelerated"] is False
          and nonneg.summary["reason"] == "nonnegative=True",
          f"small nonnegative ALS: err {nn_err:.3g}, summary {nonneg.summary}")
    # the host library's grouped layout at a ragged shape (destinations
    # without edges, degrees off the group size) against numpy's
    ru, ri = rng.integers(997, size=12_345), rng.integers(313, size=12_345)
    rc = (rng.random(12_345) * 4 + 1).astype(np.float32)
    for dst, src, n_dst in ((ru, ri, 1000), (ri, ru, 317)):
        for p in (0, 8, 13):
            native = als_ops.build_grouped_edges(dst, src, rc, n_dst, p)
            plain = als_ops.build_grouped_edges_np(dst, src, rc, n_dst, p)
            check(all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(native, plain)),
                  f"grouped edges n_dst={n_dst} p={p}: the host library differs from numpy")
    emit("small_slices", {"pca_shapes": [list(sh) for sh in PCA_SMALL],
                          "pca_routes": sorted(routes), "pca_gram_rel_err": gram_errs,
                          "gram_ranks": [1, 7, 32, 70],
                          "solve_ranks": [1, 10, 32], "fits": ["pca", "als implicit",
                                                               "als explicit"],
                          "als_wide_rank": wide, "nonnegative_err": nn_err,
                          "grouped_edges_bit_equal": True})


def als_wide_rank(dev, rng, rank=1030):
    """An implicit fit at a rank above the factor Gram kernel's bound on a
    tiny table: the Gram takes the ``matmul`` route (the summary says so,
    no Gram launch), the solve ``torch.linalg``; held against the numpy
    oracle."""
    u, i = rng.integers(30, size=200), rng.integers(20, size=200)
    rt = (rng.random(200) * 4 + 1).astype(np.float32)
    als_kernel.reset_launches()
    model = ALS(rank=rank, max_iter=2, implicit_prefs=True, alpha=5.0, seed=2,
                device=str(dev)).fit(u, i, rt, 30, 20)
    s = model.summary
    check(s["gram_route"] == "matmul" and s["solve_kernel"] == "torch.linalg",
          f"ALS rank {rank}: gram route {s['gram_route']}, solve {s['solve_kernel']}")
    check(s["kernels"] == {als_kernel.SOLVE: 0, als_kernel.GRAM: 0},
          f"ALS rank {rank}: kernel launches {s['kernels']}")
    pred = model.user_factors_ @ model.item_factors_.T
    xr, yr = als_np.als_np(u, i, rt, 30, 20, rank, 2, 0.1, 5.0, True, seed=2)
    err = float(np.linalg.norm(pred - xr @ yr.T) / np.linalg.norm(xr @ yr.T))
    check(np.all(np.isfinite(pred)) and err <= 1e-3,
          f"ALS rank {rank} vs numpy oracle: {err:.3g}")
    return {"rank": rank, "gram_route": s["gram_route"], "kernels": s["kernels"],
            "rel_err_vs_numpy": err}


# -- ring and the sharded K-Means fit ----------------------------------------

def mesh_devices(dev, world):
    """``world`` ranks: distinct cards when the machine has that many,
    else every rank on ``dev``."""
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return [torch.device("cuda", i) for i in range(world)]
    return [dev] * world


def sync_all(devs):
    for d in dict.fromkeys(devs):
        sync(d)


def time_ms_all(fn, devs, reps, warm=1):
    """Mean ms per call: CUDA events when every rank is on one card, the
    host clock between synchronisations of every card otherwise."""
    if len(set(devs)) == 1:
        return time_ms(fn, devs[0], reps, warm)
    for _ in range(warm):
        fn()
    sync_all(devs)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all(devs)
    return (time.perf_counter() - t0) * 1e3 / reps


def ring_bound(rows, cols, world, distinct):
    """Least time of one allreduce of ``world`` f32 (rows, cols) buffers:
    on one card every input read and every result written once over HBM;
    across cards the 2 (W - 1) / W of a buffer that any allreduce brings
    into each card over NVLink, or each card's read and write over HBM,
    whichever is longer.  The (W - 1) adds per element on FP32."""
    nbytes = 4.0 * rows * cols
    t_ops = (world - 1) * rows * cols / PEAK_FP32
    if distinct:
        t_bytes = max(2.0 * (world - 1) / world * nbytes / PEAK_NVLINK,
                      2.0 * nbytes / PEAK_BYTES)
        return _bound(t_ops / world, t_bytes)
    return _bound(t_ops, 2.0 * world * nbytes / PEAK_BYTES)


def phase_ring_kernels(cfg, dev, reps):
    """The ring kernel against the plain ring, bit for bit, at every
    shape, world and segment count; times, bounds, yardsticks."""
    variants = []
    wide, wide_shape = cfg["wide"]
    cases = [(world, cfg["shapes"]) for world in cfg["worlds"]] + [(wide, [wide_shape])]
    for world, shapes in cases:
        # a world past the cards: every rank on the one card
        devs = mesh_devices(dev, world)
        distinct = len(set(devs)) > 1
        layout = "distinct cards" if distinct else f"all on {devs[0]}"
        for rows, cols in shapes:
            g = torch.Generator()
            g.manual_seed(rows * cols + world)
            parts = [(torch.randn((rows, cols), generator=g) * 10.0).to(d) for d in devs]
            for segs in cfg["segments"]:
                tag = f"ring world={world} {rows}x{cols} segments={segs}"
                out = ring_kernel.ring_allreduce(parts, segs)
                again = ring_kernel.ring_allreduce(parts, segs)
                plain = ring_kernel.ring_allreduce_plain(parts, segs)
                sync_all(devs)
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                exact = all(torch.equal(a, b) for a, b in zip(out, plain))
                ranks_equal = all(torch.equal(out[0], o.to(out[0].device)) for o in out)
                check(same, f"{tag}: two launches differ")
                check(exact, f"{tag}: kernel differs from the plain ring")
                check(ranks_equal, f"{tag}: ranks hold different sums")
                ref = torch.sum(torch.stack([p.double().to(devs[0]) for p in parts]), 0)
                v = {
                    "world": world, "shape": [rows, cols], "segments": segs,
                    "layout": layout, "bit_equal_to_plain": exact, "deterministic": same,
                    "max_abs_err": max(float(torch.max(torch.abs(a - b.to(a.device))))
                                       for a, b in zip(out, plain)),
                    "err_vs_f64_sum": float(torch.max(torch.abs(out[0].double() - ref))),
                    "ms": time_ms_all(lambda: ring_kernel.ring_allreduce(parts, segs),
                                      devs, reps),
                    "plain_ms": time_ms_all(
                        lambda: ring_kernel.ring_allreduce_plain(parts, segs), devs,
                        max(1, reps // 4)),
                }
                v["bound_ms"], v["bound_by"] = ring_bound(rows, cols, world, distinct)
                ring_kernel.reset_launches()
                ring_kernel.ring_allreduce(parts, segs)
                v["launches_per_ring"] = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
                want = len(set(devs)) if dev.type == "cuda" else 0
                check(v["launches_per_ring"] == want,
                      f"{tag}: {v['launches_per_ring']} launches, expected one per card ({want})")
                if not distinct:
                    v["library_call"] = "torch.sum(torch.stack(parts), 0)"
                    v["library_ms"] = time_ms_all(
                        lambda: torch.sum(torch.stack(parts), 0), devs, reps)
                elif torch.cuda.nccl.is_available(parts):
                    bufs = [torch.zeros_like(p) for p in parts]
                    v["library_call"] = "torch.cuda.nccl.all_reduce (in place)"
                    v["library_ms"] = time_ms_all(
                        lambda: torch.cuda.nccl.all_reduce(bufs), devs, reps)
                else:
                    v["library_call"], v["library_ms"] = None, None
                variants.append(v)
                emit("ring_variant", v)
            del parts
    return variants


def phase_sharded_fit(cfg, dev):
    """The model-sharded K-Means path on a (data, model) mesh: its Lloyd
    loop against the one-device kernel loop from the same centers, then
    the estimator through the mesh route with the counts zeroed just
    before."""
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    world = cfg["data"] * cfg["model"]
    devs = mesh_devices(dev, world)
    layout = ",".join(str(x) for x in devs)
    emit("sharded_layout", {"devices": layout, "distinct_cards": len(set(devs)) > 1,
                            "mesh": {"data": cfg["data"], "model": cfg["model"]}})
    set_config(model_parallel=cfg["model"])
    try:
        mesh = get_mesh(devices=resolve_devices(layout))
        # from centers near the blob centers: every row lies far from a
        # Voronoi boundary, so the two routes' products (the kernel's FP32
        # sums and cuBLAS's, in other orders) give the same labels; from
        # random rows, near-ties flip a few labels of small clusters
        x, _, c0 = blobs(n, d, k, devs[0], seed=0)
        ones = torch.ones(n, device=devs[0])
        d_pad = -(-d // cfg["model"]) * cfg["model"]
        x_pad = torch.nn.functional.pad(x, (0, d_pad - d))
        table = ShardedTable.from_numpy(x_pad, mesh)
        c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0.contiguous(), it, 1e-4)
        c2, it2, cost2, _ = kmeans_ops.lloyd_run_model_sharded(
            table.tiles, table.mask, torch.nn.functional.pad(c0, (0, d_pad - d)), it, 1e-4,
            mesh, "data", "model")
        c_err = _rel_err(c2[:, :d].to(c1.device), c1)
        cost_err = abs(float(cost2) - float(cost1)) / float(cost1)
        check(it1 == it2, f"sharded loop: {it2} iterations, one-device kernel loop {it1}")
        check(c_err <= 1e-4, f"sharded loop: centers rel err {c_err:.3g}")
        check(cost_err <= 1e-5, f"sharded loop: cost rel err {cost_err:.3g}")
        del table, c1, c2, ones

        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        for x_dev in set(devs):
            if x_dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(x_dev)
        t0 = time.perf_counter()
        model = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, device=layout).fit(x)
        wall = time.perf_counter() - t0
        launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    finally:
        set_config(model_parallel=1)
    s = model.summary
    dd, mm = cfg["data"], cfg["model"]
    # one launch per card per ring, one ring per model column per pass
    ring_cards = sum(len({mesh.device(r) for r in group}) for group in mesh.groups("data"))
    expect = (s.num_iter + 1) * ring_cards if dev.type == "cuda" else 0
    check(s.kernels == launches, f"summary kernels {s.kernels} != counters {launches}")
    check(launches[ring_kernel.KERNEL] == expect,
          f"ring_reduce launched {launches[ring_kernel.KERNEL]} times, expected "
          f"(num_iter + 1) * (cards of every ring) = {expect}")
    check(launches[kmeans_kernel.KERNEL] == 0, "the mesh route launched the one-device kernel")
    check(s.mesh == {"data": dd, "model": mm} and s.ring is True,
          f"summary mesh {s.mesh}, ring {s.ring}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (k, d)
          and np.all(np.isfinite(model.cluster_centers_)),
          "sharded fit: non-finite cost or centers, or wrong center shape")
    check(abs(float(np.sum(s.cluster_sizes)) - n) <= 1e-3 * n,
          "sharded fit: cluster sizes do not add up to the rows")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"sharded fit: compute_cost {cost} vs training cost {s.training_cost}")
    phases = s.timings.as_dict()
    fit = {
        "devices": layout, "mesh": s.mesh, "ring": s.ring, "shape": [n, d], "k": k,
        "num_iter": s.num_iter, "training_cost": s.training_cost, "compute_cost": cost,
        "wall_s": wall, "phases_s": phases,
        "iters_per_s": s.num_iter / phases["lloyd_loop"], "launches": launches,
        "loop_parity": {"n_iter": it2, "centers_rel_err": c_err, "cost_rel_err": cost_err},
        "peak_mem_gb": ({str(x_dev): torch.cuda.max_memory_allocated(x_dev) / 1e9
                         for x_dev in set(devs)} if dev.type == "cuda" else None),
    }
    emit("sharded_fit", fit)
    return fit


def phase_dp_fit(cfg, dev):
    """The data-parallel K-Means path on a (data W, model 1) mesh: its
    Lloyd loop against the one-device kernel loop from the same centers
    near the blob centers (equal iterations, centers within 1e-4, cost
    within 1e-5), then ``KMeans(k, max_iter).fit(x)`` on the device list
    with the counts zeroed just before: K1 launches (num_iter + 1) * W,
    one a rank a pass, no ring."""
    n, d, k, it, world = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"], cfg["data"]
    devs = mesh_devices(dev, world)
    layout = ",".join(str(x) for x in devs)
    set_config(model_parallel=1)
    mesh = get_mesh(devices=resolve_devices(layout))
    x, _, c0 = blobs(n, d, k, devs[0], seed=0)
    ones = torch.ones(n, device=devs[0])
    table = ShardedTable.from_numpy(x, mesh)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0.contiguous(), it, 1e-4)
    t0 = time.perf_counter()
    c2, it2, cost2, _ = kmeans_ops.lloyd_run_data_parallel(
        table.tiles, table.mask, c0, it, 1e-4, mesh, "data")
    sync_all(devs)
    loop_s = time.perf_counter() - t0
    c_err = _rel_err(c2.to(c1.device), c1)
    cost_err = abs(float(cost2) - float(cost1)) / float(cost1)
    check(it1 == it2, f"data-parallel loop: {it2} iterations, one-device kernel loop {it1}")
    check(c_err <= 1e-4, f"data-parallel loop: centers rel err {c_err:.3g}")
    check(cost_err <= 1e-5, f"data-parallel loop: cost rel err {cost_err:.3g}")
    del table, c1, c2, ones

    kmeans_kernel.reset_launches()
    ring_kernel.reset_launches()
    t0 = time.perf_counter()
    model = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, device=layout).fit(x)
    wall = time.perf_counter() - t0
    launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    s = model.summary
    expect = (s.num_iter + 1) * world if dev.type == "cuda" else 0
    check(s.kernels == launches, f"summary kernels {s.kernels} != counters {launches}")
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"kmeans_accumulate launched {launches[kmeans_kernel.KERNEL]} times on the "
          f"data-parallel route, expected (num_iter + 1) * {world} = {expect}")
    check(launches[ring_kernel.KERNEL] == 0 and s.ring is False,
          "the data-parallel route ran the ring")
    check(s.mesh == {"data": world, "model": 1}, f"summary mesh {s.mesh}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (k, d)
          and np.all(np.isfinite(model.cluster_centers_)),
          "data-parallel fit: non-finite cost or centers, or wrong center shape")
    check(abs(float(np.sum(s.cluster_sizes)) - n) <= 1e-3 * n,
          "data-parallel fit: cluster sizes do not add up to the rows")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"data-parallel fit: compute_cost {cost} vs training cost {s.training_cost}")
    tiles = ShardedTable.from_numpy(x, mesh)
    centers = {rk: torch.as_tensor(model.cluster_centers_, device=mesh.device(rk))
               for rk in mesh.ranks}
    iteration = mesh_breakdown(lambda: [
        kmeans_kernel.lloyd_accumulate(tiles.tiles[rk], tiles.mask[rk], centers[rk],
                                       "highest", False) for rk in mesh.ranks], devs)
    del tiles
    phases = s.timings.as_dict()
    fit = {
        "devices": layout, "mesh": s.mesh, "shape": [n, d], "k": k, "pass_by_card": iteration,
        "num_iter": s.num_iter, "training_cost": s.training_cost, "wall_s": wall,
        "phases_s": phases, "iters_per_s": s.num_iter / phases["lloyd_loop"],
        "launches": launches,
        "loop_parity": {"n_iter": it2, "centers_rel_err": c_err, "cost_rel_err": cost_err,
                        "iters_per_s": it2 / loop_s},
    }
    emit("dp_fit", fit)
    return fit


def phase_pca_mesh_fit(cfg, dev):
    """The PCA path on a device list, on a (data 4, model 1) and a
    (data 2, model 2) mesh, counts zeroed just before each fit: K2
    launches twice a rank on (4, 1) (the mean and the Gram pass) and not
    at all on (2, 2) (the model-sharded Gram is a library product, as in
    the JAX package); each fit against the one-device fit, components
    sign-insensitively within 1e-4 and ratios within 1e-5."""
    (n, d), k = cfg["shapes"][0], cfg["k"]
    x = pca_data(n, d, dev, seed=d)
    one = PCA(k=k, device=str(dev)).fit(x)
    keep = one.explained_variance_ > 1e-5
    out = []
    for data, model in ((4, 1), (2, 2)):
        devs = mesh_devices(dev, data * model)
        layout = ",".join(str(v) for v in devs)
        set_config(model_parallel=model)
        try:
            pca_kernel.reset_launches()
            t0 = time.perf_counter()
            fit = PCA(k=k, device=layout).fit(x)
            wall = time.perf_counter() - t0
            launches = dict(pca_kernel.LAUNCHES)
        finally:
            set_config(model_parallel=1)
        s = fit.summary
        expect = (2 * data if model == 1 else 0) if dev.type == "cuda" else 0
        check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
        check(launches[pca_kernel.KERNEL] == expect,
              f"pca_moments launched {launches[pca_kernel.KERNEL]} times on ({data}, {model}), "
              f"expected {expect}")
        check(s["mesh_shape"] == {"data": data, "model": model}, f"mesh {s['mesh_shape']}")
        comp_err = sign_err(fit.components_[:, keep], one.components_[:, keep])
        ratio_err = float(np.max(np.abs(fit.explained_variance_ - one.explained_variance_)))
        check(comp_err <= 1e-4 and ratio_err <= 1e-5,
              f"pca on ({data}, {model}) vs one device: components {comp_err:.3g}, "
              f"ratios {ratio_err:.3g}")
        v = {"mesh": s["mesh_shape"], "devices": layout, "shape": [n, d], "k": k,
             "wall_s": wall, "phases_s": s["timings"].as_dict(), "launches": launches,
             "components_err": comp_err, "ratio_err": ratio_err}
        emit("pca_mesh_fit", v)
        out.append(v)
    return out


def phase_als_block_fit(cfg, data, dev, one_device):
    """The block-parallel ALS path on four ranks (distinct cards when the
    machine has four), counts zeroed just before: implicit
    ``ALS(rank, max_iter, alpha, reg)`` at the ML-25M shape, held against
    the one-device fit of ``als_fit`` in prediction space on its user
    sample (rows 0..4095 of X Y^T) within 1e-4 relative.  Launches: every
    iteration each of the W ranks solves its users (K3) with the Gram of
    its copy of Y (K4), then every item (K3) with the psum of the W
    X-block Grams (K4), so K3 = K4 = 2 W max_iter."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["rank"], cfg["max_iter"]
    if one_device is None:
        one_device = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                         alpha=cfg["alpha"], seed=0, device=str(dev)).fit(
            users, items, ratings, n_users, n_items)
    world = 4
    devs = mesh_devices(dev, world)
    layout = ",".join(str(v) for v in devs)
    als_kernel.reset_launches()
    t0 = time.perf_counter()
    model = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                alpha=cfg["alpha"], seed=0, device=layout).fit(
        users, items, ratings, n_users, n_items)
    wall = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    s = model.summary
    # the model keeps the fit's live blocks: nothing gathered yet
    kept = bool(s.get("sharded_factors")) and model._user_factors is None
    check(kept, "block ALS: the fit gathered its user factors")
    model.fit_launches = launches
    expect = 2 * world * it if dev.type == "cuda" else 0
    check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect},
          f"block ALS launches {launches}, expected 2 * {world} * {it} = {expect} of each")
    check(s["block_parallel"] and s["num_user_blocks"] == world
          and s["item_layout"] == "replicated", f"block summary {s}")
    q = np.arange(min(4096, n_users))
    on = torch.device(model.device)
    got = (torch.as_tensor(model.user_factors_[q], device=on)
           @ torch.as_tensor(model.item_factors_, device=on).T)
    want = (torch.as_tensor(one_device.user_factors_[q], device=on)
            @ torch.as_tensor(one_device.item_factors_, device=on).T)
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    del got, want
    check(np.all(np.isfinite(model.user_factors_)) and np.all(np.isfinite(model.item_factors_)),
          "block ALS: non-finite factors")
    check(err <= 1e-4, f"block ALS vs the one-device fit: prediction rel err {err:.3g}")
    # one iteration of the block loop, profiled card by card
    mesh = get_mesh(devices=resolve_devices(layout), model_parallel=1)
    edges = als_block.prepare_block_inputs(users, items, ratings, world, n_users)
    sides = als_block.prepare_grouped_inputs(edges, mesh, n_items, r)
    ranks = als_block.data_ranks(mesh)
    x0 = {q: torch.zeros((edges.upb, r), device=mesh.device(q)) for q in ranks}
    y0 = {q: torch.as_tensor(model.item_factors_, device=mesh.device(q)) for q in ranks}

    def one_iteration():
        return als_block.als_block_run_grouped(sides, x0, y0, 1, cfg["reg"], cfg["alpha"],
                                               mesh, implicit=True)

    one_iteration()
    iteration = mesh_breakdown(one_iteration, devs)
    del sides, edges
    phases = s["timings"].as_dict()
    fit = {"devices": layout, "world": world, "layout": s["als_kernel"], "wall_s": wall,
           "phases_s": phases, "iters_per_s": it / phases["als_iterations"],
           "launches": launches, "pred_rel_err_vs_one_device": err, "users_compared": len(q),
           "iteration_by_card": iteration, "sharded_factors": kept}
    emit("als_block_fit", fit)
    return fit, model


# -- out of core: the streamed routes and the 2-D ALS layout ------------------

def pinned_h2d_rate(dev, nbytes=1 << 30):
    """Bytes per second of one ``nbytes`` copy from pinned host memory to
    the card (CUDA events, the mean of three after a warm one); None in
    a rehearsal."""
    if dev.type != "cuda":
        return None
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: dst.copy_(host, non_blocking=True), dev, reps=3)
    del host, dst
    return nbytes / (ms / 1e3)


def stream_profile(fn, dev):
    """One call of ``fn`` under torch.profiler: the card's kernel time
    (the compute stream's busy time), its copy time (the side stream's
    host-to-device copies) and the compute stream's idle share of the
    call's wall; None on the CPU or where the profiler records nothing."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        evs = [ev for ev in prof.events() if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        if evs:
            break
    if not evs:
        return None
    copy = sum(ev.time_range.elapsed_us() for ev in evs if "memcpy" in ev.name.lower()) / 1e3
    compute = sum(ev.time_range.elapsed_us() for ev in evs
                  if "memcpy" not in ev.name.lower()) / 1e3
    return {"profiled_wall_ms": wall, "kernel_ms": compute, "copy_ms": copy,
            "idle_share": max(0.0, 1.0 - compute / wall)}


def stream_pass(run, phase, dev, nbytes, kernel_bound_ms, rate):
    """One streamed pass, ``run(timings)``: its wall, the prefetch split
    it recorded under ``phase``, the card's idle share while it ran
    (a second, profiled call), and its bound: the larger of its bytes
    over the measured pinned host-to-device rate and the summed bound of
    its kernel launches."""
    t = Timings()
    sync(dev)
    t0 = time.perf_counter()
    run(t)
    sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    copy_ms = nbytes / rate * 1e3 if rate else None
    return {"wall_ms": wall, "split_ms": {k: v * 1e3 for k, v in t.subphases(phase).items()},
            "overlap_efficiency": t.overlap_efficiency(phase),
            "profile": stream_profile(lambda: run(None), dev), "bytes": nbytes,
            "bound_ms": max(copy_ms or 0.0, kernel_bound_ms),
            "bound_by": ("host-to-device copy" if (copy_ms or 0.0) >= kernel_bound_ms
                         else "kernels"),
            "copy_bound_ms": copy_ms, "kernel_bound_ms": kernel_bound_ms}


def source_walk_ms(src):
    """Host ms of one bare walk of a source (its chunks copied into fresh
    buffers, nothing staged): the first of the two host copies a pass
    makes; the pinned copy is the prefetch ``transfer`` split."""
    t0 = time.perf_counter()
    for _ in src:
        pass
    return (time.perf_counter() - t0) * 1e3


def pred_rel_err(model, ref, n_users, dev):
    """Relative difference of two ALS fits in prediction space on users
    0..4095 x every item, on the card."""
    q = np.arange(min(4096, n_users))
    got = (torch.as_tensor(model.user_factors_[q], device=dev)
           @ torch.as_tensor(model.item_factors_, device=dev).T)
    want = (torch.as_tensor(ref.user_factors_[q], device=dev)
            @ torch.as_tensor(ref.item_factors_, device=dev).T)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def staged_ends(src, dev, stage_dtype=torch.float32):
    """The first and the last chunk of ``src`` as a streamed pass stages
    them (pinned buffers, the side stream): ``[(x, w, n_valid), ...]``
    on ``dev``, x widened to f32 as the kernels take it, cloned."""
    last = -(-src.n_rows // src.chunk_rows) - 1
    ends = []
    with stream_ops._staged_chunks(src, None, dev, PrefetchStats(), stage_dtype) as pf:
        for i, ((_, n_valid, _), (x, w)) in enumerate(pf):
            if i in (0, last):
                ends.append((stream_ops._operand(x).clone(), w.clone(), n_valid))
    return ends


def stream_chunk_checks(src, c, dev):
    """K1 on a full and a ragged staged chunk against its plain version
    (:func:`compare`, loop and cost mode at highest, as the streamed loop
    and its cost pass run it); on the ragged one the padding must carry
    no weight: the counts sum to its valid rows, and its cost is the
    plain version's on the valid rows alone (1e-4, the highest tier's
    cost gate)."""
    out = []
    for x, w, n_valid in staged_ends(src, dev):
        for need_cost in (False, True):
            v = compare(x, w, c, "highest", need_cost)
            v.update(rows=int(x.shape[0]), n_valid=n_valid)
            out.append(v)
        _, counts, cost = kmeans_kernel.lloyd_accumulate(x, w, c, "highest", True)
        _, _, ref = kmeans_kernel.lloyd_accumulate_plain(x[:n_valid], w[:n_valid], c,
                                                         "highest", True)
        err = abs(float(cost) - float(ref)) / max(abs(float(ref)), 1e-30)
        check(float(counts.sum()) == n_valid and err <= 1e-4,
              f"K1 on a chunk of {n_valid} valid rows: counts sum {float(counts.sum())}, "
              f"cost {err:.3g} from the valid rows' cost")
        out[-1]["cost_vs_valid_rows_rel_err"] = err
    return out


def phase_stream_kmeans(cfg, dev):
    """The streamed K-Means path on the headline table as a
    ``ChunkSource`` of ``chunk_rows`` rows: ``lloyd_run_streamed`` and the
    one-device ``lloyd_run_kernel`` from the same centers near the blob
    centers (equal iterations, centers within 1e-4, cost within 1e-5),
    K1 launched chunks x (iterations + 1) times; one loop pass's split,
    idle share and bound; then ``KMeans(...).fit(source)`` with its
    phases and route.  Returns what the route and sparse phases reuse."""
    n, d, k, rows = cfg["n"], cfg["d"], cfg["k"], cfg["chunk_rows"]
    x, _, c0 = blobs(n, d, k, dev, seed=0)
    host = x.cpu().numpy()
    src = ChunkSource.from_array(host, chunk_rows=rows)
    chunks = -(-n // src.chunk_rows)
    ones = torch.ones(n, device=dev)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0, 20, 1e-4)
    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    c2, it2, cost2, _ = stream_ops.lloyd_run_streamed(src, c0, 20, 1e-4)
    sync(dev)
    loop_s = time.perf_counter() - t0
    launches = dict(kmeans_kernel.LAUNCHES)
    expect = chunks * (it2 + 1) if dev.type == "cuda" else 0
    c_err = _rel_err(c2, c1)
    cost_err = abs(float(cost2) - float(cost1)) / float(cost1)
    check(it1 == it2, f"streamed loop: {it2} iterations, one-device kernel loop {it1}")
    check(c_err <= 1e-4, f"streamed loop: centers rel err {c_err:.3g}")
    check(cost_err <= 1e-5, f"streamed loop: cost rel err {cost_err:.3g}")
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"streamed loop: K1 launched {launches[kmeans_kernel.KERNEL]} times, expected "
          f"chunks x (iterations + 1) = {expect}")
    # a table whose length is no multiple of the chunk width: K1 on its
    # first and its padded last chunk against the plain version, and a
    # whole streamed cost pass against the one-device pass on its rows
    nr = n - cfg["cut"]
    ragged = ChunkSource.from_array(host[:nr], chunk_rows=rows)
    chunk_checks = stream_chunk_checks(ragged, c2, dev)
    s_r, n_r, t_r = stream_ops.streamed_accumulate(ragged, c2, "highest", True)
    s_1, n_1, t_1 = kmeans_kernel.lloyd_accumulate(x[:nr], ones[:nr], c2, "highest", True)
    ragged_pass = {"rows": nr,
                   "tail_valid": nr - (nr - 1) // ragged.chunk_rows * ragged.chunk_rows,
                   "sums_rel_err": _rel_err(s_r, s_1),
                   "counts_equal": bool(torch.equal(n_r, n_1)),
                   "cost_rel_err": abs(float(t_r) - float(t_1)) / float(t_1)}
    check(ragged_pass["sums_rel_err"] <= RTOL["highest"] and ragged_pass["counts_equal"]
          and ragged_pass["cost_rel_err"] <= 1e-5,
          f"streamed pass over {nr} rows vs the one-device pass: {ragged_pass}")
    del c1, ones, x, s_r, s_1
    rate = pinned_h2d_rate(dev)
    k_bound = chunks * bound(src.chunk_rows, d, k, "highest")[0]
    lloyd_pass = stream_pass(
        lambda t: stream_ops.streamed_accumulate(src, c2, "highest", False, timings=t,
                                                 phase="pass"),
        "pass", dev, chunks * src.chunk_rows * (d + 1) * 4, k_bound, rate)
    walk = source_walk_ms(src)

    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    model = KMeans(k=k, max_iter=cfg["fit_iter"], tol=1e-4, seed=0, device=str(dev)).fit(src)
    wall = time.perf_counter() - t0
    fit_launches = dict(kmeans_kernel.LAUNCHES)
    s = model.summary
    check(s.streamed and s.route["route"] == "streamed", f"streamed fit route {s.route}")
    check(s.kernels == fit_launches, f"summary kernels {s.kernels} != counters {fit_launches}")
    check(fit_launches[kmeans_kernel.KERNEL] == (chunks * (s.num_iter + 1)
                                                 if dev.type == "cuda" else 0),
          f"streamed fit: K1 launched {fit_launches[kmeans_kernel.KERNEL]} times")
    check(np.isfinite(s.training_cost) and np.all(np.isfinite(model.cluster_centers_))
          and abs(float(np.sum(s.cluster_sizes)) - n) <= 1e-3 * n,
          "streamed fit: non-finite output or cluster sizes off")
    phases = s.timings.as_dict()
    out = {"shape": [n, d], "k": k, "chunk_rows": src.chunk_rows, "chunks": chunks,
           "h2d_pinned_gb_s": rate / 1e9 if rate else None,
           "loop": {"n_iter": it2, "centers_rel_err": c_err, "cost_rel_err": cost_err,
                    "launches": launches, "iters_per_s": it2 / loop_s},
           "chunk_checks": chunk_checks, "ragged_pass": ragged_pass,
           "lloyd_pass": lloyd_pass, "source_walk_ms": walk,
           "fit": {"wall_s": wall, "phases_s": phases, "num_iter": s.num_iter,
                   "training_cost": s.training_cost, "launches": fit_launches,
                   "route": s.route, "iters_per_s": s.num_iter / phases["lloyd_loop"],
                   "init_split": s.timings.subphases("init_centers"),
                   "lloyd_split": s.timings.subphases("lloyd_loop")}}
    emit("stream_kmeans", out)
    return out, host, model


def phase_stream_route(cfg, host, streamed, dev):
    """The route planner: ``KMeans.fit(ndarray)`` with the card budget one
    byte below ``plan_kmeans``'s estimate of the natural route takes the
    streamed route and gives the fit of the source fit (its chunks have
    the same width); for a 2^27 x 256 f32 table (128 GB, beyond the
    card) ``plan_kmeans`` and ``plan_pca`` under the detected budget say
    "streamed" (the planner alone: nothing is allocated)."""
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    hint = kmeans_ops.auto_row_chunks(n, k)
    plan = membudget.plan_kmeans(n, d, k, row_chunks_hint=hint, device=dev)
    natural = plan.estimate_for(plan.natural).hbm_bytes
    set_config(memory_budget_hbm=str(natural - 1))
    try:
        kmeans_kernel.reset_launches()
        t0 = time.perf_counter()
        model = KMeans(k=k, max_iter=cfg["fit_iter"], tol=1e-4, seed=0,
                       device=str(dev)).fit(host)
        wall = time.perf_counter() - t0
        launches = dict(kmeans_kernel.LAUNCHES)
    finally:
        set_config(memory_budget_hbm="")
    s = model.summary
    check(s.streamed and s.route["route"] == "streamed" and s.route["degraded_scale"],
          f"a budget below the in-memory estimate did not stream: {s.route}")
    width = ChunkSource.from_array(host[:1], chunk_rows=s.route["chunk_rows"]).chunk_rows
    if width != streamed.summary.route["chunk_rows"]:
        # a rehearsal's source fit ran at another width: refit at this one
        streamed = KMeans(k=k, max_iter=cfg["fit_iter"], tol=1e-4, seed=0, device=str(dev)).fit(
            ChunkSource.from_array(host, chunk_rows=width))
    ref = streamed.summary
    c_err = float(np.max(np.abs(model.cluster_centers_ - streamed.cluster_centers_))
                  / max(np.max(np.abs(streamed.cluster_centers_)), 1e-30))
    check(s.num_iter == ref.num_iter and c_err <= 1e-6
          and abs(s.training_cost - ref.training_cost) <= 1e-6 * ref.training_cost,
          f"routed fit vs the source fit: {s.num_iter} / {ref.num_iter} iterations, "
          f"centers {c_err:.3g}")
    big = 1 << 27
    km = membudget.plan_kmeans(big, d, k, row_chunks_hint=kmeans_ops.auto_row_chunks(big, k),
                               device=dev)
    pc = membudget.plan_pca(big, d, device=dev)
    if dev.type == "cuda":
        check(km.route == "streamed" and pc.route == "streamed",
              f"a 128 GB table planned {km.route} / {pc.route}")
    out = {"budget_hbm": natural - 1, "route": s.route, "wall_s": wall,
           "phases_s": s.timings.as_dict(), "launches": launches,
           "centers_rel_err_vs_source_fit": c_err,
           "big_table": {"shape": [big, d], "kmeans": km.as_dict(), "pca": pc.as_dict()}}
    emit("stream_route", out)
    return out


def pca_chunk_checks(src, dev, policy):
    """K2 on a full and a ragged staged chunk (staged at the policy's
    dtype) against its plain version at the policy's tier, both passes:
    column sums and count within PCA_SUM_RTOL, the count equal to the
    chunk's valid rows (the padding carries weight 0), the Gram about
    the table's mean within PCA_GRAM_RTOL."""
    tier = psn.kernel_tier(policy, "highest")
    out = []
    for x, w, n_valid in staged_ends(src, dev, psn.staging_dtype(policy)):
        _, cs, cnt = pca_kernel.pca_moments(x, w, None, tier, need_gram=False)
        _, cs_p, cnt_p = pca_kernel.pca_moments_plain(x, w, None, tier, need_gram=False)
        mean = cs_p / max(float(cnt_p), 1.0)
        g, _, _ = pca_kernel.pca_moments(x, w, mean, tier, need_sums=False)
        g_p, _, _ = pca_kernel.pca_moments_plain(x, w, mean, tier, need_sums=False)
        v = {"policy": policy, "tier": tier, "rows": int(x.shape[0]), "n_valid": n_valid,
             "count": float(cnt), "colsum_rel_err": _rel_err(cs, cs_p),
             "gram_rel_err": _rel_err(g, g_p),
             "max_abs_err": float(torch.max(torch.abs(g - g_p)))}
        check(v["colsum_rel_err"] <= PCA_SUM_RTOL and float(cnt) == n_valid
              and v["gram_rel_err"] <= PCA_GRAM_RTOL[tier],
              f"K2 on a staged chunk of {n_valid} valid rows: {v}")
        out.append(v)
    return out


def phase_stream_pca(cfg, dev, rate):
    """The streamed PCA path: the PCA table as a ``ChunkSource``, K2 on
    every chunk of both passes (2 x chunks launches), components within
    1e-5 sign-insensitively and ratios within 1e-5 of the in-memory fit;
    the same under the bf16 policy against the in-memory bf16 fit, within
    the JAX package's registered bf16 bounds for PCA (the subspace angle
    5e-2 rad, the ratios 1e-2), which the in-memory bf16 fit also meets
    against the f32 one."""
    (n, d), k, rows = cfg["shapes"][0], cfg["k"], cfg["chunk_rows"]
    x = pca_data(n, d, dev, seed=d)
    host = x.cpu().numpy()
    src = ChunkSource.from_array(host, chunk_rows=rows)
    chunks = -(-n // src.chunk_rows)
    nr = n - cfg["cut"]
    ragged = ChunkSource.from_array(host[:nr], chunk_rows=rows)
    out = {"shape": [n, d], "k": k, "chunk_rows": src.chunk_rows, "chunks": chunks}
    for policy in ("f32", "bf16"):
        set_config(compute_precision=policy)
        try:
            resident = PCA(k=k, device=str(dev)).fit(x)
            pca_kernel.reset_launches()
            t0 = time.perf_counter()
            model = PCA(k=k, device=str(dev)).fit(src)
            wall = time.perf_counter() - t0
            launches = dict(pca_kernel.LAUNCHES)
        finally:
            set_config(compute_precision="f32")
        s = model.summary
        check(s["streamed"] and s["route"]["route"] == "streamed" and s["n_rows"] == n,
              f"streamed PCA summary {s.get('route')}")
        expect = 2 * chunks if dev.type == "cuda" else 0
        check(launches[pca_kernel.KERNEL] == expect and s["kernels"] == launches,
              f"streamed PCA: K2 launched {launches[pca_kernel.KERNEL]} times, expected {expect}")
        keep = resident.explained_variance_ > 1e-5
        comp_err = sign_err(model.components_[:, keep], resident.components_[:, keep])
        ratio_err = float(np.max(np.abs(model.explained_variance_
                                        - resident.explained_variance_)))
        sv = np.linalg.svd(model.components_.T @ resident.components_, compute_uv=False)
        angle = float(np.arccos(np.clip(sv.min(), 0.0, 1.0)))
        if policy == "f32":
            check(comp_err <= 1e-5 and ratio_err <= 1e-5,
                  f"streamed PCA vs in-memory: components {comp_err:.3g}, ratios {ratio_err:.3g}")
            f32_resident = resident
        else:
            sv32 = np.linalg.svd(resident.components_.T @ f32_resident.components_,
                                 compute_uv=False)
            angle32 = float(np.arccos(np.clip(sv32.min(), 0.0, 1.0)))
            ratio32 = float(np.max(np.abs(resident.explained_variance_
                                          - f32_resident.explained_variance_)))
            check(angle <= 5e-2 and ratio_err <= 1e-2,
                  f"streamed bf16 PCA vs in-memory bf16: angle {angle:.3g}, ratios {ratio_err:.3g}")
            check(angle32 <= 5e-2 and ratio32 <= 1e-2,
                  f"in-memory bf16 PCA vs f32: angle {angle32:.3g}, ratios {ratio32:.3g}")
        v = {"wall_s": wall, "phases_s": s["timings"].as_dict(), "launches": launches,
             "components_err": comp_err, "ratio_err": ratio_err, "subspace_rad": angle,
             "route": s["route"], "resident_wall_s": sum(resident.summary["timings"]
                                                         .as_dict().values())}
        if policy == "bf16":
            v.update(resident_vs_f32={"subspace_rad": angle32, "ratio_err": ratio32})
        v["chunk_checks"] = pca_chunk_checks(ragged, dev, policy)
        out[policy] = v
    # the ragged table streamed against its in-memory fit, at the f32 gates
    streamed_r = PCA(k=k, device=str(dev)).fit(ragged)
    resident_r = PCA(k=k, device=str(dev)).fit(x[:nr])
    keep = resident_r.explained_variance_ > 1e-5
    out["ragged_fit"] = {
        "rows": nr, "components_err": sign_err(streamed_r.components_[:, keep],
                                               resident_r.components_[:, keep]),
        "ratio_err": float(np.max(np.abs(streamed_r.explained_variance_
                                         - resident_r.explained_variance_)))}
    check(streamed_r.summary["n_rows"] == nr and out["ragged_fit"]["components_err"] <= 1e-5
          and out["ragged_fit"]["ratio_err"] <= 1e-5,
          f"streamed PCA of {nr} rows vs in-memory: {out['ragged_fit']}")
    k_bound = chunks * (pca_bound(src.chunk_rows, d, "highest", False)[0]
                        + pca_bound(src.chunk_rows, d, "highest", True)[0])
    out["passes"] = stream_pass(
        lambda t: stream_ops.covariance_streamed(src, "highest", t, device=dev),
        "covariance_streamed", dev, 2 * chunks * src.chunk_rows * (d + 1) * 4, k_bound, rate)
    emit("stream_pca", out)
    return out


def phase_stream_als(cfg, data, dev, resident, rate):
    """The streamed ALS path: the implicit fit routed streamed by a card
    budget one byte below the in-memory estimate, counts zeroed just
    before: K3 and K4 twice an iteration; held against the in-memory fit
    of ``als_fit`` (the same numpy-seeded init) in prediction space on
    its user sample within 1e-5; iterations/s beside it; one
    iteration's split, idle share and bound.  Then a triples
    ``ChunkSource`` fit on a small table against its array fit."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["rank"], cfg["max_iter"]
    plan = membudget.plan_als(len(users), n_users, n_items, r, device=dev)
    budget = plan.estimate_for("in-memory").hbm_bytes - 1
    set_config(memory_budget_hbm=str(budget))
    try:
        als_kernel.reset_launches()
        t0 = time.perf_counter()
        model = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                    alpha=cfg["alpha"], seed=0, device=str(dev)).fit(
            users, items, ratings, n_users, n_items)
        wall = time.perf_counter() - t0
        launches = dict(als_kernel.LAUNCHES)
    finally:
        set_config(memory_budget_hbm="")
    s = model.summary
    check(s.get("streamed") and s["route"]["route"] == "streamed",
          f"streamed ALS route {s.get('route')}")
    expect = 2 * it if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect} == s["kernels"],
          f"streamed ALS launches {launches}, expected {expect} of each")
    err = pred_rel_err(model, resident, n_users, dev)
    check(err <= 1e-5, f"streamed ALS vs in-memory: prediction rel err {err:.3g}")
    bit_equal = bool(np.array_equal(model.user_factors_, resident.user_factors_)
                     and np.array_equal(model.item_factors_, resident.item_factors_))
    phases = s["timings"].as_dict()
    rphases = resident.summary["timings"].as_dict()
    by_user = als_ops.build_grouped_edges(users, items, ratings, n_users)
    by_item = als_ops.build_grouped_edges(items, users, ratings, n_items)
    x0, y0 = als_np.init_factors(n_users, r, 0), als_np.init_factors(n_items, r, 1)
    nbytes = sum(a.nbytes for side in (by_user, by_item) for a in side[:3])
    k_bound = (solve_bound(n_users, r, True)[0] + solve_bound(n_items, r, True)[0]
               + gram_bound(n_users, r)[0] + gram_bound(n_items, r)[0])
    iteration = stream_pass(
        lambda t: als_stream.als_run_streamed(by_user, by_item, x0, y0, n_users, n_items, 1,
                                              cfg["reg"], cfg["alpha"], True, t, device=dev),
        "als_iterations", dev, nbytes, k_bound, rate)
    del by_user, by_item

    rng = np.random.default_rng(5)
    su, si = rng.integers(700, size=20_000), rng.zipf(1.3, size=20_000) % 300
    sr = (rng.random(20_000) * 4 + 1).astype(np.float32)
    src = ChunkSource.from_array(np.stack([su, si, sr], 1).astype(np.float64),
                                 chunk_rows=4096)
    kw = dict(rank=r, max_iter=3, reg_param=cfg["reg"], implicit_prefs=True,
              alpha=cfg["alpha"], seed=0, device=str(dev))
    als_kernel.reset_launches()
    sfit = ALS(**kw).fit(src, n_users=700, n_items=300)
    src_launches = dict(als_kernel.LAUNCHES)
    afit = ALS(**kw).fit(su, si, sr, 700, 300)
    src_err = _rel_err(torch.as_tensor(sfit.user_factors_ @ sfit.item_factors_.T),
                       torch.as_tensor(afit.user_factors_ @ afit.item_factors_.T))
    check(sfit.summary.get("streamed") and src_err <= 1e-5,
          f"triples source fit vs array fit: {src_err:.3g}")
    out = {"n_users": n_users, "n_items": n_items, "nnz": len(users), "rank": r,
           "budget_hbm": budget, "wall_s": wall, "phases_s": phases, "launches": launches,
           "iters_per_s": it / phases["als_iterations"],
           "resident_iters_per_s": it / rphases["als_iterations"],
           "pred_rel_err_vs_resident": err, "bit_equal_to_resident": bit_equal,
           "route": s["route"], "iteration": iteration,
           "source_fit": {"pred_rel_err_vs_array_fit": src_err, "launches": src_launches}}
    emit("stream_als", out)
    return out


def block_rows(table, offsets, per, dev):
    """Rows ``[offsets[b], offsets[b + 1])`` of ``table`` as block b, zero
    padded to ``per`` rows (the 2-D layout's factor blocks)."""
    out = []
    for b in range(len(offsets) - 1):
        blk = np.zeros((per, table.shape[1]), np.float32)
        blk[: offsets[b + 1] - offsets[b]] = table[offsets[b]:offsets[b + 1]]
        out.append(torch.from_numpy(blk).to(dev))
    return out


def solve_check(tag, a, b, n_reg, reg, gram):
    """K3 against its plain version on one rank's inputs, as
    :func:`phase_als_kernels` holds it: two launches equal, the rows with
    no ratings 0, bit-equal to the plain version on the rest."""
    valid = n_reg > 0
    w = als_kernel.solve_normal_eq(a, b, n_reg, reg, gram)
    same = torch.equal(w, als_kernel.solve_normal_eq(a, b, n_reg, reg, gram))
    w_p = als_kernel.solve_plain(a, b, n_reg, reg, gram)
    err = _rel_err(w[valid], w_p[valid])
    bit_equal = torch.equal(w[valid], w_p[valid])
    check(same and bool(torch.all(w[~valid] == 0)), f"{tag}: launches differ or empty rows not 0")
    check(bool(torch.all(torch.isfinite(w))) and err <= SOLVE_RTOL and bit_equal,
          f"{tag}: rel err {err:.3g}, bit-equal {bit_equal}")
    return {"systems": int(b.shape[0]), "r": int(b.shape[1]), "rel_err": err,
            "bit_equal": bit_equal, "max_abs_err": float(torch.max(torch.abs(w - w_p)))}


def gram_check(tag, f):
    """K4 against its plain version on one rank's factor block (1e-5),
    deterministic and bit-symmetric."""
    g = als_kernel.factor_gram(f)
    same = torch.equal(g, als_kernel.factor_gram(f))
    g_p = als_kernel.factor_gram_plain(f)
    err = _rel_err(g, g_p)
    check(same and (f.device.type != "cuda" or torch.equal(g, g.T)) and err <= 1e-5,
          f"{tag}: rel err {err:.3g}, deterministic {same}")
    return {"rows": int(f.shape[0]), "r": int(f.shape[1]), "rel_err": err,
            "max_abs_err": float(torch.max(torch.abs(g - g_p)))}


def block_2d_kernel_checks(cfg, data, model, devs):
    """K3 and K4 at the 2-D layout's per-rank shapes: the sides built as
    the fit builds them (the shuffles by user and by item block), the
    fitted factors cut into blocks; rank 0's user and item half-updates
    (its destinations, the other side's gathered blocks, the psum of the
    block Grams) against the plain versions."""
    users, items, ratings = data
    n_users, n_items, r, world = cfg["n_users"], cfg["n_items"], cfg["wide_rank"], len(devs)
    mesh = get_mesh(devices=resolve_devices(",".join(str(v) for v in devs)), model_parallel=1)
    by_user = als_block.prepare_block_inputs(users, items, ratings, world, n_users)
    by_item = als_block.prepare_block_inputs(items, users, ratings, world, n_items)
    grouped, sizes = als_block.block_grouped_guard_2d(users, items, n_users, n_items, world)
    sides = (als_block.prepare_grouped_inputs_2d(by_user, by_item, mesh, r, sizes) if grouped
             else als_block.prepare_coo_inputs_2d(by_user, by_item, mesh, r))
    q0 = als_block.data_ranks(mesh)[0]
    on = mesh.device(q0)
    xb = block_rows(model.user_factors_, by_user.offsets, by_user.upb, on)
    yb = block_rows(model.item_factors_, by_item.offsets, by_item.upb, on)
    out = {"layout": "grouped" if grouped else "coo"}
    for name, side, src in (("users", sides.users[q0], yb), ("items", sides.items[q0], xb)):
        gram = sum(als_kernel.factor_gram_plain(f) for f in src)
        a, b, n_reg = side.partials(torch.cat(src), cfg["alpha"], True, "f32")
        out[name] = {"solve": solve_check(f"2-D rank 0 {name} solve", a, b, n_reg, cfg["reg"],
                                          gram),
                     "gram": gram_check(f"2-D rank 0 {name} source block Gram", src[0])}
        del a, b, n_reg
    del sides
    return out


def phase_als_block_2d(cfg, data, dev):
    """The 2-D ALS item layout: implicit rank 32 at the ML-25M shape on four
    ranks (distinct cards when the machine has four) with the default
    ``als_item_layout="auto"``, which shards the items past the
    crossover; counts zeroed just before: K3 = K4 = 2 x 4 x max_iter.
    Held against the one-device rank-32 fit in prediction space on 4096
    users within 1e-4 (the block phase's gate); iterations/s; the peak
    memory of each card against the replicated layout's."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["wide_rank"], cfg["max_iter"]
    kw = dict(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
              alpha=cfg["alpha"], seed=0)
    one = ALS(device=str(dev), **kw).fit(users, items, ratings, n_users, n_items)
    devs = mesh_devices(dev, 4)
    layout = ",".join(str(v) for v in devs)
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    runs = {}
    # the 2-D layout as the default "auto" picks it (a rehearsal's table is
    # below the crossover and asks for it), then the replicated layout
    for item_layout in (cfg["layout_2d"], "replicated"):
        set_config(als_item_layout=item_layout)
        try:
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            als_kernel.reset_launches()
            t0 = time.perf_counter()
            m = ALS(device=layout, **kw).fit(users, items, ratings, n_users, n_items)
            m.fit_launches = dict(als_kernel.LAUNCHES)
            runs[m.summary["item_layout"]] = {
                "model": m, "wall_s": time.perf_counter() - t0,
                "launches": m.fit_launches, "kept": m._user_factors is None,
                "peak_mem_gb": {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 1e9
                                for c in cards}}
        finally:
            set_config(als_item_layout="auto")
    check(set(runs) == {"sharded", "replicated"}, f"item layouts {sorted(runs)}")
    model, launches = runs["sharded"]["model"], runs["sharded"]["launches"]
    s = model.summary
    check(all(run["kept"] for run in runs.values()) and model._item_factors is None,
          "2-D ALS: a block fit gathered its factors")
    expect = 2 * 4 * it if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect} == s["kernels"],
          f"2-D ALS launches {launches}, expected 2 * 4 * {it} = {expect} of each")
    errs = {name: pred_rel_err(runs[name]["model"], one, n_users, dev) for name in runs}
    check(np.all(np.isfinite(model.user_factors_)) and errs["sharded"] <= 1e-4,
          f"2-D ALS vs the one-device fit: prediction rel err {errs['sharded']:.3g}")
    kernel_checks = block_2d_kernel_checks(cfg, data, model, devs)
    check(kernel_checks["layout"] == s["als_kernel"],
          f"the checked layout {kernel_checks['layout']} is not the fit's {s['als_kernel']}")
    phases = s["timings"].as_dict()
    rphases = runs["replicated"]["model"].summary["timings"].as_dict()
    peaks = {name: runs[name]["peak_mem_gb"] for name in runs}
    out = {"devices": layout, "rank": r, "item_layout": s["item_layout"],
           "layout": s["als_kernel"], "wall_s": runs["sharded"]["wall_s"], "phases_s": phases,
           "launches": launches, "iters_per_s": it / phases["als_iterations"],
           "replicated_iters_per_s": it / rphases["als_iterations"],
           "replicated_phases_s": rphases, "pred_rel_err_vs_one_device": errs,
           "peak_mem_gb_by_card": peaks, "kernel_checks": kernel_checks,
           "one_device_iters_per_s": it / one.summary["timings"].as_dict()["als_iterations"]}
    emit("als_block_2d", out)
    return out, model


def als_source(users, items, ratings):
    """Ratings as a width-3 (user, item, rating) f64 ``ChunkSource``: ids
    and f32 ratings are exact in f64."""
    return ChunkSource.from_array(np.stack([users, items, ratings], 1).astype(np.float64),
                                  chunk_rows=ALS_SOURCE_ROWS)


def factor_rel_err(a, b):
    """max |a - b| / max |b| of two factor tables (0 when bit-equal)."""
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def phase_block_stream(cfg, data, dev):
    """The streamed block ALS (ops/als_block_stream.py): the ML-25M ratings
    as a width-3 source on four ranks (distinct cards when the machine
    has four), implicit, rank 10 with replicated items and rank 32 in
    the 2-D layout, each held against the resident block fit of the same
    mesh and rank: the factors bit-equal (each rank's chunks are its
    resident blocks of groups; the gate is 1e-5 relative), K3 = K4 = 2 x
    4 x max_iter with the summary's counts equal to the counters, the
    route "streamed-block"; iterations/s, ``table_convert`` seconds, each
    card's peak memory beside the resident route's, and the card's idle
    share of one streamed iteration (torch.profiler)."""
    users, items, ratings = data
    n_users, n_items, it = cfg["n_users"], cfg["n_items"], cfg["max_iter"]
    devs = mesh_devices(dev, 4)
    layout = ",".join(str(v) for v in devs)
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    src = als_source(users, items, ratings)
    out = []
    for r, item_layout in ((cfg["rank"], "replicated"), (cfg["wide_rank"], "sharded")):
        kw = dict(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                  alpha=cfg["alpha"], seed=0)
        fits = {}
        set_config(als_item_layout=item_layout)
        try:
            for route, args in (("streamed", (src,)), ("resident", (users, items, ratings))):
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
                als_kernel.reset_launches()
                t0 = time.perf_counter()
                m = ALS(device=layout, **kw).fit(*args, n_users=n_users, n_items=n_items)
                fits[route] = {"model": m, "wall_s": time.perf_counter() - t0,
                               "launches": dict(als_kernel.LAUNCHES),
                               "peak_mem_gb": {f"cuda:{c}": torch.cuda.max_memory_allocated(c)
                                               / 1e9 for c in cards}}
            iteration = streamed_iteration_profile(cfg, data, r, item_layout, devs,
                                                   fits["streamed"]["model"])
        finally:
            set_config(als_item_layout="auto")
        st, rs = fits["streamed"], fits["resident"]
        s = st["model"].summary
        expect = 2 * 4 * it if dev.type == "cuda" else 0
        check(st["launches"] == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect}
              == s["kernels"], f"block_stream rank {r}: launches {st['launches']}, summary "
              f"{s['kernels']}, expected 2 * 4 * {it} = {expect} of each")
        check(s["streamed"] and s["block_parallel"] and s["item_layout"] == item_layout
              and s["route"]["route"] == "streamed-block" and "streamed" not in rs["model"].summary,
              f"block_stream rank {r}: summary {s}")
        um, im = st["model"], rs["model"]
        check(np.all(np.isfinite(um.user_factors_)) and np.all(np.isfinite(um.item_factors_)),
              f"block_stream rank {r}: non-finite factors")
        errs = {"user": factor_rel_err(um.user_factors_, im.user_factors_),
                "item": factor_rel_err(um.item_factors_, im.item_factors_)}
        bit = (np.array_equal(um.user_factors_, im.user_factors_)
               and np.array_equal(um.item_factors_, im.item_factors_))
        check(max(errs.values()) <= 1e-5,
              f"block_stream rank {r}: factors {errs} from the resident block fit")
        phases, rphases = s["timings"].as_dict(), rs["model"].summary["timings"].as_dict()
        v = {"devices": layout, "rank": r, "item_layout": item_layout,
             "launches": st["launches"], "bit_equal_to_resident": bool(bit),
             "factor_rel_err_vs_resident": errs, "wall_s": st["wall_s"], "phases_s": phases,
             "iters_per_s": it / phases["als_iterations"],
             "table_convert_s": phases["table_convert"],
             "resident_iters_per_s": it / rphases["als_iterations"],
             "resident_phases_s": rphases, "peak_mem_gb": st["peak_mem_gb"],
             "resident_peak_mem_gb": rs["peak_mem_gb"], "iteration": iteration,
             "balance": s["balance"]}
        emit("block_stream", v)
        out.append(v)
        del fits, st, rs, um, im
    return out


def streamed_iteration_profile(cfg, data, r, item_layout, devs, model):
    """One iteration of the streamed block loop at the fit's layout, from
    the fitted factors, profiled card by card (the card's idle share of
    the iteration's wall)."""
    users, items, ratings = data
    mesh = get_mesh(devices=list(devs), model_parallel=1)
    lay = als_block_stream.prepare_streamed_block_layouts(
        users, items, ratings, cfg["n_users"], cfg["n_items"], mesh, r,
        item_sharded=item_layout == "sharded")
    ranks = als_block.data_ranks(mesh)

    def blocks(table, offsets, per):
        return {q: blk.to(mesh.device(q))
                for q, blk in zip(ranks, block_rows(table, offsets, per, torch.device("cpu")))}

    x0 = blocks(model.user_factors_, lay.offsets_u, lay.upb)
    y0 = (blocks(model.item_factors_, lay.by_item.offsets, lay.by_item.upb) if lay.item_sharded
          else {q: torch.as_tensor(model.item_factors_, device=mesh.device(q)) for q in ranks})

    def one_iteration():
        return als_block_stream.als_block_run_streamed(lay, x0, y0, 1, cfg["reg"],
                                                       cfg["alpha"], mesh, implicit=True)

    one_iteration()
    out = mesh_breakdown(one_iteration, list(devs))
    return {**(out or {}), "host_split": streamed_iteration_split(one_iteration, lay, devs)}


def streamed_iteration_split(one_iteration, lay, devs):
    """Where the host's wall of one streamed iteration goes, in ms: the
    producer's staging (gathering a chunk into pinned buffers) and its
    pinned copies' issue, the consumer's waits for a staged chunk, and
    the psums across the ranks (each between syncs of every card, so the
    psum's own time: this iteration is not the timed one)."""
    st = lay.stats
    before = (st.stage_s, st.transfer_s, st.wait_s)
    psum_s = [0.0]
    real = collective.psum_group

    def timed_psum(*a, **k):
        sync_all(devs)
        t0 = time.perf_counter()
        got = real(*a, **k)
        sync_all(devs)
        psum_s[0] += time.perf_counter() - t0
        return got

    collective.psum_group = timed_psum
    try:
        sync_all(devs)
        t0 = time.perf_counter()
        one_iteration()
        sync_all(devs)
        wall = time.perf_counter() - t0
    finally:
        collective.psum_group = real
    stage, transfer, wait = (a - b for a, b in zip((st.stage_s, st.transfer_s, st.wait_s),
                                                    before))
    return {"wall_ms": wall * 1e3, "staging_ms": (stage - transfer) * 1e3,
            "pinned_copy_issue_ms": transfer * 1e3, "consumer_wait_ms": wait * 1e3,
            "psum_ms": psum_s[0] * 1e3,
            "consumer_other_ms": (wall - wait - psum_s[0]) * 1e3}


def phase_sparse_input(cfg, dev):
    """SciPy CSR input: ``KMeans.fit`` and ``PCA.fit`` of a CSR table equal
    the fits of its dense copy (the same f32 table reaches the card, the
    kernels are deterministic: equal bits); counts zeroed before each."""
    import scipy.sparse as sp

    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    rng = np.random.default_rng(11)
    dense = rng.normal(size=(n, d)).astype(np.float32)
    dense[rng.random((n, d)) < 0.9] = 0.0
    dense[:, : d // 4] += rng.integers(k, size=(n, 1)).astype(np.float32)
    csr = sp.csr_matrix(dense)
    out = {"shape": [n, d], "density": csr.nnz / (n * d), "k": k}
    kmeans_kernel.reset_launches()
    pca_kernel.reset_launches()
    fits = {}
    for name, x in (("dense", dense), ("csr", csr)):
        fits[name] = (KMeans(k=k, max_iter=10, seed=0, device=str(dev)).fit(x),
                      PCA(k=cfg["pca_k"], device=str(dev)).fit(x))
    launches = {**kmeans_kernel.LAUNCHES, **pca_kernel.LAUNCHES}
    (kd, pd), (ks, ps) = fits["dense"], fits["csr"]
    check(np.array_equal(ks.cluster_centers_, kd.cluster_centers_)
          and ks.summary.training_cost == kd.summary.training_cost,
          "KMeans: the CSR fit differs from the dense fit")
    check(np.array_equal(ps.components_, pd.components_)
          and np.array_equal(ps.explained_variance_, pd.explained_variance_),
          "PCA: the CSR fit differs from the dense fit")
    if dev.type == "cuda":
        check(launches[kmeans_kernel.KERNEL] == 2 * (kd.summary.num_iter + 1)
              and launches[pca_kernel.KERNEL] == 4, f"sparse_input launches {launches}")
    out.update(launches=launches, num_iter=ks.summary.num_iter,
               kmeans_phases_s=ks.summary.timings.as_dict())
    emit("sparse_input", out)
    return out


# -- several processes ------------------------------------------------------------
# Worlds of processes that this script spawns by running itself with
# ``--mp-worker``: world "a", one rank a process (2 processes on the one
# card; 4, one card each, under --mesh), and world "b", two ranks a
# process (2 processes).  Each process makes only its own rows from the
# seed; the parent holds every fit against the one-process fit of the
# same shape afterwards.
MP_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "pca": (1 << 20, 128),
           "pca_k": 16, "chunk_rows": 1 << 16, "stream_iter": 5, "reps": 10,
           "ring_shapes": [(1000, 130), (13, 37), (65536, 256)], "als": ALS_FULL,
           "als_cut": 0.46, "drill_iter": 6, "drill_sleep_s": 0.1, "div_rows": 1 << 16}
MP_TINY = {"n": 4096, "d": 29, "k": 11, "max_iter": 5, "pca": (3000, 37), "pca_k": 5,
           "chunk_rows": 256, "stream_iter": 3, "reps": 1,
           "ring_shapes": [(1000, 130), (13, 37), (512, 256)], "als": ALS_TINY,
           "als_cut": 0.46, "drill_iter": 6, "drill_sleep_s": 0.02, "div_rows": 2048}
MP_BLOCK = 1 << 16  # rows a seeded generator makes: any process makes its own
MP_TIMEOUT_S = 900


def blob_rows(n, lo, hi, d, k, seed, dev):
    """Rows ``[lo, hi)`` of an n-row table of Gaussian blobs, and centers
    near the blob centers: every block of ``MP_BLOCK`` rows comes from a
    generator of its own, so a process makes its rows alone and the
    whole table is the concatenation of every process's."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    true = torch.randn((k, d), generator=g, device=dev) * 2.0
    c0 = true + 0.5 * torch.randn((k, d), generator=g, device=dev)
    parts = []
    for b in range(lo // MP_BLOCK, -(-hi // MP_BLOCK)):
        b0, b1 = b * MP_BLOCK, min(n, (b + 1) * MP_BLOCK)
        gb = torch.Generator(device=dev)
        gb.manual_seed(seed * 1000003 + b + 1)
        lab = torch.randint(0, k, (b1 - b0,), generator=gb, device=dev)
        rows = true[lab] + torch.randn((b1 - b0, d), generator=gb, device=dev)
        parts.append(rows[max(lo, b0) - b0:min(hi, b1) - b0])
    return torch.cat(parts).contiguous(), c0.contiguous()


def spectrum_rows(n, lo, hi, d, seed, dev):
    """Rows ``[lo, hi)`` of ``pca_data``'s kind of table (a decaying
    spectrum around a mean of 3), block by block as :func:`blob_rows`."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=torch.float32)
    parts = []
    for b in range(lo // MP_BLOCK, -(-hi // MP_BLOCK)):
        b0, b1 = b * MP_BLOCK, min(n, (b + 1) * MP_BLOCK)
        gb = torch.Generator(device=dev)
        gb.manual_seed(seed * 1000003 + b + 1)
        z = torch.randn((b1 - b0, d), generator=gb, device=dev) * scale
        parts.append((z @ q.T + 3.0)[max(lo, b0) - b0:min(hi, b1) - b0])
    return torch.cat(parts).contiguous()


def mp_local_devices(world, rank, mesh, rehearse):
    """A worker's own devices: world "a" one, world "b" two; the one card
    for every process, or under --mesh cards of its own."""
    per = 2 if world == "b" else 1
    if rehearse:
        return ",".join(["cpu"] * per)
    if mesh:
        return ",".join(f"cuda:{rank * per + j}" for j in range(per))
    return ",".join(["cuda:0"] * per)


def mp_same(tag, value):
    """Fail unless every process holds the same ``value`` (bytes)."""
    from oap_mllib_tpu_torch.parallel import collective

    digest = np.frombuffer(hashlib.sha256(value).digest(), np.uint8)
    (all_d,) = collective.process_allgather([digest])
    check(bool((all_d == all_d[0]).all()), f"{tag}: the processes hold different results")


def mp_timed(fn, n, dev):
    """Milliseconds a call of ``fn`` (a collective: every process times
    it together), after one warm call and a barrier."""
    from oap_mllib_tpu_torch.parallel import collective

    fn()
    sync(dev)
    collective.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def gloo_bare(part):
    """A bare gloo ``all_gather`` of ``part``'s bytes, already on the
    host, into a buffer made beforehand: what the host path's transport
    costs without the port's copies."""
    import torch.distributed as dist

    host = part.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty((dist.get_world_size(), host.numel()), dtype=torch.uint8)
    views = list(out.unbind(0))
    return lambda: dist.all_gather(views, host)


def mp_ring(cfg, dev, rank, nproc):
    """K5 across the processes: a ring of one member a process (world "a")
    at every shape, the kernel over IPC bit-equal to the plain version
    across processes and to the one-process plain ring of the gathered
    parts, two launches bit-equal, one launch a process a ring; times of
    the kernel call (barriers included), the plain version and the gloo
    host path (process_allgather, then a sum) for the same payload."""
    from oap_mllib_tpu_torch.parallel import collective

    out = []
    groups, owner = [list(range(nproc))], (lambda m: m)
    if dev.type == "cuda":
        # a handle does not open in the process that made it: the hazard
        # the wrapper steps round by using its own pointer
        lib = ring_kernel._library()
        ptr, handle = ctypes.c_void_p(), (ctypes.c_ubyte * 64)()
        check(lib.ring_ws_alloc(dev.index, 1 << 20, 256, ctypes.byref(ptr), handle) == 0,
              "mp_ring: a test workspace")
        mapped = ctypes.c_void_p()
        own_err = lib.ring_ipc_open(dev.index, bytes(handle), ctypes.byref(mapped))
        check(own_err != 0, "mp_ring: a process opened its own IPC handle")
        check(lib.ring_ws_free(dev.index, ptr) == 0, "mp_ring: freeing the test workspace")
    for rows, cols in cfg["ring_shapes"]:
        g = torch.Generator()
        g.manual_seed(rows * cols + 7 * rank)
        part = (torch.randn((rows, cols), generator=g) * 10.0).to(dev)
        mine = {rank: part}
        ring_kernel.reset_launches()
        got = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        launches = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
        again = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        plain = ring_kernel.ring_allreduce_groups_plain(mine, groups, owner)[rank]
        (all_parts,) = collective.process_allgather([part])
        one = ring_kernel.ring_allreduce_plain([torch.from_numpy(a) for a in all_parts])[0]
        sync(dev)
        tag = f"mp_ring world={nproc} {rows}x{cols}"
        check(torch.equal(got, again), f"{tag}: two launches differ")
        check(torch.equal(got, plain), f"{tag}: kernel differs from the plain version")
        check(torch.equal(got.cpu(), one), f"{tag}: differs from the one-process plain ring")
        want = 1 if dev.type == "cuda" else 0
        check(launches == want, f"{tag}: {launches} launches in this process, expected {want}")
        mp_same(tag, got.cpu().numpy().tobytes())
        reps = cfg["reps"]
        # the timed calls after a warm one (which grew the workspace): no
        # host collective among them, the host's one wait a call
        ring = lambda: ring_kernel.ring_allreduce_groups(mine, groups, owner)  # noqa: E731
        ring()
        sync(dev)
        collective.barrier()
        ring_kernel.reset_ipc_stats()
        before = host_collectives()
        t0 = time.perf_counter()
        for _ in range(reps):
            ring()
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        after = host_collectives()
        stats = dict(ring_kernel.IPC_STATS)
        made = {key: after[key] - before[key] for key in after}
        check(dev.type != "cuda" or not any(made.values()),
              f"{tag}: {made} host collectives across {reps} timed calls, expected none")
        n_gloo = max(1, reps // 2)

        def gloo_host():
            return torch.as_tensor(collective.process_allgather([part])[0].sum(axis=0)).to(dev)

        # the recovery watcher's cost a host collective: disarmed
        # (collective_timeout 0), armed (the default), armed, disarmed
        unwatched = []
        set_config(collective_timeout=0.0)
        unwatched.append(mp_timed(gloo_host, n_gloo, dev))
        set_config(collective_timeout=600.0)
        collective.reset_host_stats()
        gloo_ms = mp_timed(gloo_host, n_gloo, dev)
        host = dict(collective.HOST_STATS)
        watched_again = mp_timed(gloo_host, n_gloo, dev)
        set_config(collective_timeout=0.0)
        unwatched.append(mp_timed(gloo_host, n_gloo, dev))
        set_config(collective_timeout=600.0)
        # the collective sanitizer's cost a host collective (its
        # cross-check is one more gloo all_gather, 192 bytes): off, on,
        # on, off, every process alike
        sanitized = []
        for on in (False, True, True, False):
            set_config(sanitizers="collective" if on else "")
            sanitized.append(mp_timed(gloo_host, n_gloo, dev))
        set_config(sanitizers="")
        # the same payload's bytes through gloo alone, host to host
        bare_ms = mp_timed(gloo_bare(part), n_gloo, dev)
        plain_ms = mp_timed(lambda: ring_kernel.ring_allreduce_groups_plain(mine, groups, owner),
                            max(1, reps // 4), dev)
        distinct = dev.type == "cuda" and torch.cuda.device_count() >= nproc and nproc > 1 \
            and MP_STATE.get("mesh", False)
        bound_ms, bound_by = ring_bound(rows, cols, nproc, distinct)
        v = {"world": nproc, "shape": [rows, cols], "layout": "distinct cards" if distinct
             else f"all on {dev}", "bit_equal_to_plain": True, "launches_per_process": launches,
             "max_abs_err": float(torch.max(torch.abs(got - plain))), "ms": ms,
             "plain_ms": plain_ms, "gloo_host_ms": gloo_ms, "gloo_bare_ms": bare_ms,
             "gloo_host_ms_watched": [gloo_ms, watched_again],
             "gloo_host_ms_unwatched": unwatched,
             "watcher_ms": (gloo_ms + watched_again - sum(unwatched)) / 2.0,
             "gloo_host_ms_sanitized": sanitized[1:3],
             "gloo_host_ms_unsanitized": [sanitized[0], sanitized[3]],
             "sanitizer_ms": (sanitized[1] + sanitized[2] - sanitized[0] - sanitized[3]) / 2.0,
             # the host path's time inside gloo's all_gather and in all of
             # process_allgather (copies included), a call
             "gloo_host_gloo_ms": 1e3 * host["gloo_s"] / max(1, host["calls"]),
             "gloo_host_exchange_ms": 1e3 * host["seconds"] / max(1, host["calls"]),
             "payload_mb": rows * cols * 4 / 1e6, "bound_ms": bound_ms,
             "bound_by": bound_by,
             # the host's one wait a call (the gloo barriers' key before
             # K5 signalled on the card) and the card's waits for the peers
             "barrier_ms_per_call": 1e3 * stats["barrier_s"] / max(1, stats["calls"]),
             "device_wait_ms": 1e3 * stats["device_wait_s"] / max(1, stats["calls"]),
             "host_collectives_timed": made, "timed_calls": reps,
             "host_ms_per_call": 1e3 * stats["total_s"] / max(1, stats["calls"])}
        emit("mp_ring_variant", v)
        out.append(v)
    if dev.type == "cuda":
        out.append(mp_ring_failure(dev, rank, nproc))
    return out


def host_collectives():
    """This process's host collectives so far: every dispatch of the
    collective facade (``oap_collective_ops_total``: gathers, all_to_all,
    barriers, agreements), the host exchanges (``HOST_STATS``) and the
    census's host ops."""
    series = tel_metrics.snapshot().get("oap_collective_ops_total", {})
    return {"dispatches": int(sum(series.values())),
            "host_exchanges": collective.HOST_STATS["calls"],
            "census": sum(collective.emitted(op) for op in ("process_allgather", "all_to_all"))}


def mp_ring_failure(dev, rank, nproc):
    """One process (the last) fails its copy into the workspace on one
    call: every process must raise the agreed RuntimeError naming it
    within seconds, and the next call, on a fresh workspace, must be
    bit-equal to the plain version again."""
    rows, cols = 1000, 130
    g = torch.Generator()
    g.manual_seed(rows * cols + 7 * rank)
    mine = {rank: (torch.randn((rows, cols), generator=g) * 10.0).to(dev)}
    groups, owner = [list(range(nproc))], (lambda m: m)
    want = ring_kernel.ring_allreduce_groups_plain(mine, groups, owner)[rank]
    bad = nproc - 1
    real = ring_kernel._copy_in

    def planted(*args):
        raise RuntimeError("mp_ring_failure: a copy in failed on purpose")

    if rank == bad:
        ring_kernel._copy_in = planted
    err = None
    t0 = time.perf_counter()
    try:
        ring_kernel.ring_allreduce_groups(mine, groups, owner)
    except RuntimeError as e:
        err = str(e)
    finally:
        ring_kernel._copy_in = real
    seconds = time.perf_counter() - t0
    tag = f"mp_ring_failure world={nproc}"
    check(err is not None and f"failed on process(es) [{bad}]" in err,
          f"{tag}: process {rank} raised {err!r}, expected the agreed error naming [{bad}]")
    check(seconds < 10.0, f"{tag}: the failed call took {seconds:.1f} s")
    before = dict(ring_kernel._ipc)
    ring_kernel.reset_launches()
    got = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
    sync(dev)
    check(torch.equal(got, want), f"{tag}: the call after the failure differs from the plain "
                                  "version")
    check(ring_kernel.LAUNCHES[ring_kernel.KERNEL] == 1 and ring_kernel._ipc["epoch"] == 1
          and ring_kernel._ipc["ptr"] is not None and not ring_kernel._ipc["stale"],
          f"{tag}: the next call ran {ring_kernel.LAUNCHES[ring_kernel.KERNEL]} launches at "
          f"epoch {ring_kernel._ipc['epoch']} (before it: stale {before['stale']})")
    v = {"world": nproc, "failed_process": bad, "seconds": seconds, "error": err[:300],
         "stale_before_next": before["stale"], "next_bit_equal": True}
    emit("mp_ring_failure", v)
    return v


def mp_ring_kill(dev, rank, nproc):
    """World "k": the last process SIGKILLs itself inside a K5 call, before
    it signals; every survivor must raise PeerAbortError (the process
    gone) or CollectiveTimeoutError within 10 s, its card's stream must
    drain (a synchronise returns), and it leaves at once."""
    import signal

    from oap_mllib_tpu_torch.utils import recovery

    rows, cols = 1000, 130
    g = torch.Generator()
    g.manual_seed(rows * cols + 7 * rank)
    mine = {rank: (torch.randn((rows, cols), generator=g) * 10.0).to(dev)}
    groups, owner = [list(range(nproc))], (lambda m: m)
    ring_kernel.ring_allreduce_groups(mine, groups, owner)
    sync(dev)
    if rank == nproc - 1:
        ring_kernel._copy_in = lambda *args: os.kill(os.getpid(), signal.SIGKILL)
    err = None
    t0 = time.perf_counter()
    try:
        ring_kernel.ring_allreduce_groups(mine, groups, owner)
    except (recovery.PeerAbortError, recovery.CollectiveTimeoutError) as e:
        err = e
    seconds = time.perf_counter() - t0
    check(err is not None, f"mp_ring_kill: process {rank} raised nothing after its peer died")
    check(seconds < 10.0, f"mp_ring_kill: the survivor took {seconds:.1f} s to raise")
    # the survivor released its own waits: its stream drains
    sync(dev)
    v = {"world": nproc, "killed_process": nproc - 1, "error_class": type(err).__name__,
         "seconds": seconds, "drained_s": time.perf_counter() - t0, "error": str(err)[:300],
         "recovery_stats": recovery.stats()}
    emit("mp_ring_kill", v)
    return v


def mp_ring_members(dev, rank, nproc):
    """World "b": rings whose processes hold two members each (one ring of
    all the members, and a ring per column as the model-sharded fit
    runs them), bit-equal to the one-process plain rings."""
    from oap_mllib_tpu_torch.parallel import collective

    rows, cols = 1000, 130
    members = 2 * nproc
    mine = {}
    for m in (2 * rank, 2 * rank + 1):
        g = torch.Generator()
        g.manual_seed(31 * m + 5)
        mine[m] = (torch.randn((rows, cols), generator=g) * 10.0).to(dev)
    (gathered,) = collective.process_allgather([torch.stack([mine[2 * rank], mine[2 * rank + 1]])])
    every = [torch.from_numpy(gathered[m // 2, m % 2]) for m in range(members)]
    for groups in ([list(range(members))], [list(range(0, members, 2)),
                                            list(range(1, members, 2))]):
        ring_kernel.reset_launches()
        got = ring_kernel.ring_allreduce_groups(mine, groups, lambda m: m // 2)
        launches = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
        for g in groups:
            one = ring_kernel.ring_allreduce_plain([every[m] for m in g])
            for m, t in zip(g, one):
                if m in got:
                    check(torch.equal(got[m].cpu(), t),
                          f"mp_ring {len(groups)} ring(s) of {len(g)}: member {m} differs "
                          "from the one-process plain ring")
        want = len(groups) if dev.type == "cuda" else 0
        check(launches == want, f"mp_ring: {launches} launches for {len(groups)} rings")
    return {"members_per_process": 2, "bit_equal": True}


def _mp_save(out, rank, name, array):
    np.save(os.path.join(out, f"rank{rank}_{name}.npy"), np.asarray(array))


def mp_kmeans(cfg, dev, rank, nproc, model, out, init):
    """The K-Means fit across the processes: this process's share of the
    headline table, counts zeroed just before: K1 (iterations + 1) a
    local rank, K5 one a process a ring on a model axis; iterations/s and
    the share of the Lloyd loop spent in host collectives."""
    from oap_mllib_tpu_torch.parallel import collective

    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    x, _ = blob_rows(n, lo, hi, d, k, 0, dev)
    set_config(model_parallel=model)
    try:
        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        collective.reset_host_stats()
        ring_kernel.reset_ipc_stats()
        t0 = time.perf_counter()
        m = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, init_mode=init).fit(x)
        wall = time.perf_counter() - t0
        launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        host = dict(collective.HOST_STATS)
        ipc = dict(ring_kernel.IPC_STATS)
    finally:
        set_config(model_parallel=1)
    s = m.summary
    local = len(resolve_devices())
    on_card = dev.type == "cuda"
    check(s.kernels == launches, f"mp_kmeans: summary kernels {s.kernels} != {launches}")
    # K1 runs on the data-parallel route (model 1); the sharded loop is
    # plain torch around the ring, as in one process
    k1_want = (s.num_iter + 1) * local if (on_card and model == 1) else 0
    check(launches[kmeans_kernel.KERNEL] == k1_want,
          f"mp_kmeans ({s.mesh}): K1 launched {launches[kmeans_kernel.KERNEL]} times, "
          f"expected {k1_want}")
    ring_want = (s.num_iter + 1) * model if (on_card and model > 1) else 0
    check(launches[ring_kernel.KERNEL] == ring_want,
          f"mp_kmeans ({s.mesh}): K5 launched {launches[ring_kernel.KERNEL]} times, "
          f"expected {ring_want}")
    check(s.processes == nproc and s.process_id == rank, "mp_kmeans: summary world")
    check(np.all(np.isfinite(m.cluster_centers_)) and np.isfinite(s.training_cost),
          "mp_kmeans: non-finite centers or cost")
    mp_same(f"mp_kmeans {s.mesh}", m.cluster_centers_.tobytes())
    tag = f"kmeans_{s.mesh['data']}x{s.mesh['model']}"
    _mp_save(out, rank, tag, m.cluster_centers_)
    loop = s.timings.as_dict()["lloyd_loop"]
    v = {"mesh": s.mesh, "processes": nproc, "init": init, "shape": [n, d], "k": k,
         "rows_here": hi - lo, "num_iter": s.num_iter, "training_cost": s.training_cost,
         "wall_s": wall, "phases_s": s.timings.as_dict(), "iters_per_s": s.num_iter / loop,
         "launches": launches, "host_collective_s": host["seconds"],
         "host_collective_gloo_s": host["gloo_s"],
         "host_collective_calls": host["calls"], "host_collective_bytes": host["bytes"],
         "host_collective_share_of_fit": host["seconds"] / wall,
         "ring_ipc_s": ipc["total_s"], "ring_barrier_s": ipc["barrier_s"], "tag": tag}
    emit("mp_kmeans", v)
    return v


def mp_pca(cfg, dev, rank, nproc, model, out):
    """PCA across the processes on (processes x local ranks / model,
    model): K2 twice a local rank on a model axis of 1, none above."""
    (n, d), k = cfg["pca"], cfg["pca_k"]
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    x = spectrum_rows(n, lo, hi, d, d, dev)
    set_config(model_parallel=model)
    try:
        pca_kernel.reset_launches()
        t0 = time.perf_counter()
        fit = PCA(k=k).fit(x)
        wall = time.perf_counter() - t0
        launches = dict(pca_kernel.LAUNCHES)
    finally:
        set_config(model_parallel=1)
    s = fit.summary
    local = len(resolve_devices())
    want = (2 * local if model == 1 else 0) if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == want,
          f"mp_pca ({s['mesh_shape']}): K2 launched {launches[pca_kernel.KERNEL]}, want {want}")
    mp_same(f"mp_pca {s['mesh_shape']}", fit.components_.tobytes())
    tag = f"pca_{s['mesh_shape']['data']}x{s['mesh_shape']['model']}"
    _mp_save(out, rank, tag + "_components", fit.components_)
    _mp_save(out, rank, tag + "_ratios", fit.explained_variance_)
    v = {"mesh": s["mesh_shape"], "processes": s["processes"], "shape": [n, d], "k": k,
         "wall_s": wall, "phases_s": s["timings"].as_dict(), "launches": launches, "tag": tag}
    emit("mp_pca", v)
    return v


def mp_stream(cfg, dev, rank, nproc, out):
    """The streamed fits across the processes: this process's share of
    the headline table as a ChunkSource; the streamed Lloyd loop from
    centers near the blob centers and the streamed covariance, every
    pass's f32 moments through K5 (one launch a process a pass)."""
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    x, c0 = blob_rows(n, lo, hi, d, k, 0, dev)
    src = ChunkSource.from_array(x.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
    del x
    kmeans_kernel.reset_launches()
    ring_kernel.reset_launches()
    t0 = time.perf_counter()
    with record_sheets() as km_sheets:
        c, n_iter, cost, counts = stream_ops.lloyd_run_streamed(
            src, c0, cfg["stream_iter"], 1e-4, "highest", device=dev)
    wall = time.perf_counter() - t0
    launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    chunks = -(-(hi - lo) // cfg["chunk_rows"])
    on_card = dev.type == "cuda"
    check(launches[kmeans_kernel.KERNEL] == (chunks * (n_iter + 1) if on_card else 0),
          f"mp_stream: K1 {launches[kmeans_kernel.KERNEL]}, expected chunks x (iterations + 1)")
    check(launches[ring_kernel.KERNEL] == (n_iter + 1 if on_card else 0),
          f"mp_stream: K5 {launches[ring_kernel.KERNEL]}, expected one a pass ({n_iter + 1})")
    mp_same("mp_stream kmeans", c.cpu().numpy().tobytes())
    _mp_save(out, rank, "stream_centers", c.cpu().numpy())
    _mp_save(out, rank, "stream_cost", np.asarray([float(cost)]))
    (pn, pd), pk = cfg["pca"], cfg["pca_k"]
    plo, phi = rank * pn // nproc, (rank + 1) * pn // nproc
    psrc = ChunkSource.from_array(spectrum_rows(pn, plo, phi, pd, pd, dev).cpu().numpy(),
                                  chunk_rows=cfg["chunk_rows"])
    pca_kernel.reset_launches()
    ring_kernel.reset_launches()
    t1 = time.perf_counter()
    with record_sheets() as pca_sheets:
        fit = PCA(k=pk).fit(psrc)
    pwall = time.perf_counter() - t1
    plaunch = {**pca_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    check(fit.summary["n_rows"] == pn, f"mp_stream pca: {fit.summary['n_rows']} rows")
    check(plaunch[ring_kernel.KERNEL] == (2 if on_card else 0),
          f"mp_stream pca: K5 {plaunch[ring_kernel.KERNEL]}, expected one a pass (2)")
    mp_same("mp_stream pca", fit.components_.tobytes())
    _mp_save(out, rank, "stream_pca_components", fit.components_)
    _mp_save(out, rank, "stream_pca_ratios", fit.explained_variance_)
    # K5 at the sheets these passes packed, on the parts they passed
    sheets = (stream_sheets("kmeans", km_sheets, cfg, dev, rank, nproc)
              + stream_sheets("pca", pca_sheets, cfg, dev, rank, nproc))
    v = {"processes": nproc, "rows_here": hi - lo, "chunk_rows": cfg["chunk_rows"],
         "num_iter": n_iter, "wall_s": wall, "s_per_pass": wall / (n_iter + 1),
         "launches": launches, "pca_wall_s": pwall, "pca_launches": plaunch,
         "ring_sheets": sheets}
    emit("mp_stream", v)
    return v


class record_sheets:
    """Within the block, every call of ``ring_kernel.ring_allreduce_groups``
    (the streamed passes' ring, stream_ops._ring_reduce_f32) keeps a copy
    of this process's part of the first sheet of each shape; the calls
    run as they would."""

    def __enter__(self):
        self.real = ring_kernel.ring_allreduce_groups
        self.sheets = {}

        def spy(parts, groups, owner, *args, **kwargs):
            for t in parts.values():
                self.sheets.setdefault(tuple(t.shape), t.detach().clone())
            return self.real(parts, groups, owner, *args, **kwargs)

        ring_kernel.ring_allreduce_groups = spy
        return self.sheets

    def __exit__(self, *exc):
        ring_kernel.ring_allreduce_groups = self.real
        return False


def stream_sheets(fit, sheets, cfg, dev, rank, nproc):
    """K5 across the processes on each sheet a streamed fit packed (its
    recorded parts, one ring of the processes): bit-equal to the plain
    version on the same parts, one launch a process; both timed.  These
    launches come after the fit's counts were read."""
    check(bool(sheets), f"mp_stream {fit}: no pass reduced through the ring")
    groups, owner = [list(range(nproc))], (lambda p: p)
    out = []
    for shape in sorted(sheets):
        mine = {rank: sheets[shape]}
        ring_kernel.reset_launches()
        got = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        launches = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
        plain = ring_kernel.ring_allreduce_groups_plain(mine, groups, owner)[rank]
        sync(dev)
        tag = f"mp_stream {fit} sheet {shape[0]}x{shape[1]}"
        check(torch.equal(got, plain), f"{tag}: the kernel differs from the plain version")
        want = 1 if dev.type == "cuda" else 0
        check(launches == want, f"{tag}: {launches} launches in this process, expected {want}")
        out.append({
            "fit": fit, "shape": list(shape), "bit_equal_to_plain": True,
            "max_abs_err": float(torch.max(torch.abs(got - plain))),
            "launches_per_process": launches,
            "ms": mp_timed(lambda: ring_kernel.ring_allreduce_groups(mine, groups, owner),
                           cfg["reps"], dev),
            "plain_ms": mp_timed(
                lambda: ring_kernel.ring_allreduce_groups_plain(mine, groups, owner),
                max(1, cfg["reps"] // 4), dev)})
        emit("mp_stream_sheet", out[-1])
    return out


def mp_als(cfg, dev, rank, nproc, out):
    """Implicit ALS across the processes: this process's uneven cut of the
    ML-25M-shaped ratings on its two ranks (K3 = K4 = 2 x local ranks x
    iterations), the shuffle across processes; and under --mesh rank 32
    with the 2-D layout."""
    from oap_mllib_tpu_torch.parallel import collective

    a = cfg["als"]
    u, i, r = als_data(a)
    sl = als_part(len(u), cfg["als_cut"], rank, nproc)
    runs = [(a["rank"], "replicated")]
    if MP_STATE.get("mesh") or dev.type == "cpu":
        runs.append((a["wide_rank"], "sharded"))
    res = []
    for rank_, layout in runs:
        set_config(als_item_layout=layout)
        try:
            als_kernel.reset_launches()
            collective.reset_host_stats()
            t0 = time.perf_counter()
            m = ALS(rank=rank_, max_iter=a["max_iter"], reg_param=a["reg"], alpha=a["alpha"],
                    implicit_prefs=True).fit(u[sl], i[sl], r[sl], n_users=a["n_users"],
                                            n_items=a["n_items"])
            wall = time.perf_counter() - t0
            launches = dict(als_kernel.LAUNCHES)
            host = dict(collective.HOST_STATS)
        finally:
            set_config(als_item_layout="auto")
        s = m.summary
        local = len(resolve_devices())
        want = 2 * local * a["max_iter"] if dev.type == "cuda" else 0
        check(launches[als_kernel.SOLVE] == want and launches[als_kernel.GRAM] == want,
              f"mp_als rank {rank_}: K3 {launches[als_kernel.SOLVE]}, K4 "
              f"{launches[als_kernel.GRAM]}, expected {want} each")
        check(s["item_layout"] == layout and s["processes"] == nproc, f"mp_als summary {s}")
        mp_same(f"mp_als rank {rank_}", m.user_factors_.tobytes() + m.item_factors_.tobytes())
        tag = f"als_r{rank_}_{layout}"
        if rank == 0:
            _mp_save(out, rank, tag + "_u", m.user_factors_[:4096])
            _mp_save(out, rank, tag + "_i", m.item_factors_)
        phases = s["timings"].as_dict()
        v = {"rank": rank_, "layout": layout, "mesh": s["mesh"], "processes": nproc,
             "ratings_here": int(sl.stop - sl.start) if sl.stop else len(u) - cut,
             "wall_s": wall, "phases_s": phases,
             "iters_per_s": a["max_iter"] / phases["als_iterations"], "launches": launches,
             "host_collective_s": host["seconds"], "host_collective_gloo_s": host["gloo_s"],
             "host_collective_calls": host["calls"], "host_collective_bytes": host["bytes"],
             "tag": tag}
        emit("mp_als", v)
        res.append(v)
    return res


def mp_block_stream(cfg, dev, rank, nproc, out):
    """The streamed block ALS across the processes: this process's uneven
    cut of the ML-25M ratings as a width-3 source, implicit rank 10 on
    its two ranks (K3 = K4 = 2 x local ranks x iterations), the shuffle
    across processes; the factors saved for the parent's one-process
    streamed block fit."""
    from oap_mllib_tpu_torch.parallel import collective

    a = cfg["als"]
    u, i, r = als_data(a)
    sl = als_part(len(u), cfg["als_cut"], rank, nproc)
    src = als_source(u[sl], i[sl], r[sl])
    del u, i, r
    als_kernel.reset_launches()
    collective.reset_host_stats()
    t0 = time.perf_counter()
    m = ALS(rank=a["rank"], max_iter=a["max_iter"], reg_param=a["reg"], alpha=a["alpha"],
            implicit_prefs=True).fit(src, n_users=a["n_users"], n_items=a["n_items"])
    wall = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    host = dict(collective.HOST_STATS)
    s = m.summary
    want = 2 * len(resolve_devices()) * a["max_iter"] if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: want, als_kernel.GRAM: want} == s["kernels"],
          f"mp_block_stream: launches {launches}, summary {s['kernels']}, expected {want} each")
    check(s["streamed"] and s["block_parallel"] and s["processes"] == nproc
          and s["route"]["route"] == "streamed-block", f"mp_block_stream summary {s}")
    mp_same("mp_block_stream", m.user_factors_.tobytes() + m.item_factors_.tobytes())
    if rank == 0:
        _mp_save(out, rank, "block_stream_u", m.user_factors_)
        _mp_save(out, rank, "block_stream_i", m.item_factors_)
    phases = s["timings"].as_dict()
    v = {"rank": a["rank"], "mesh": s["mesh"], "processes": nproc,
         "ratings_here": int(src.n_rows), "wall_s": wall, "phases_s": phases,
         "iters_per_s": a["max_iter"] / phases["als_iterations"], "launches": launches,
         "host_collective_s": host["seconds"], "host_collective_gloo_s": host["gloo_s"],
         "host_collective_bytes": host["bytes"], "balance": s["balance"]}
    emit("mp_block_stream", v)
    return v


def als_part(n, cut, rank, nproc):
    """Process ``rank``'s slice of ``n`` ratings: process 0 the first
    ``cut`` of them, the others equal parts of the rest."""
    first = int(n * cut)
    edges = [0] + [first + (n - first) * p // (nproc - 1) for p in range(nproc)]
    return slice(edges[rank], edges[rank + 1])


def pinned_map(nproc):
    """Every even process 1.0, every odd one 0.5: ``rank_capability``'s
    map for the world."""
    return ",".join(f"{p}:{1.0 if p % 2 == 0 else 0.5}" for p in range(nproc))


class SlowRows:
    """The drill's straggler: rows of a table, each slice a balanced view
    takes (one a chunk) paying ``seconds`` of sleep first.  It wraps the
    data this script hands the port; the port has no such setting."""

    def __init__(self, base, seconds):
        self._base = base
        self._seconds = seconds
        self.shape, self.ndim, self.dtype = base.shape, base.ndim, base.dtype

    def __getitem__(self, idx):
        if self._seconds:
            time.sleep(self._seconds)
        return self._base[idx]


def mp_balance(cfg, dev, rank, nproc, out):
    """Capability-weighted shares across the processes (world "a").
    Pinned capabilities (even processes 1.0, odd 0.5): the planned
    extents of the headline table over ``balance.local_sources`` (every
    process holds the whole table), the streamed Lloyd loop from the
    blob-centre start, the streamed PCA, and the block ALS offsets, each
    held against the same fit on equal shares (``capability_sharding``
    "off") within 1e-5, with every process's ``balance`` block equal.
    Then the drill: equal pinned capabilities, process 1's rows slowed
    by a sleep a chunk, the rollups armed, and the controller must
    re-plan within ``rebalance_patience + 1`` passes."""
    n, d, k, chunk = cfg["n"], cfg["d"], cfg["k"], cfg["chunk_rows"]
    xt, c0 = blob_rows(n, 0, n, d, k, 0, dev)
    x = xt.cpu().numpy()
    del xt
    (pn, pd), pk = cfg["pca"], cfg["pca_k"]
    px = spectrum_rows(pn, 0, pn, pd, pd, dev).cpu().numpy()
    a = cfg["als"]
    u, i, r = als_data(a)
    sl = als_part(len(u), cfg["als_cut"], rank, nproc)
    on_card = dev.type == "cuda"
    # the capability probe on this process's device (unused by the plans
    # below, which pin): its value and its cost, gathered
    from oap_mllib_tpu_torch.parallel import collective
    from oap_mllib_tpu_torch.utils import dispatch

    t0 = time.perf_counter()
    cap = dispatch.throughput_probe(0)
    probe = {"ms": (time.perf_counter() - t0) * 1e3}
    (caps,) = collective.process_allgather([np.asarray([cap, probe["ms"]])])
    probe.update(capabilities=caps[:, 0].tolist(), ms_by_process=caps[:, 1].tolist())
    # the default ("auto", nothing pinned): the world's processes run on
    # one model of card, as many a card, so they weigh the same whatever
    # the probes read
    set_config(capability_sharding="auto", rank_capability="")
    balance.reset()
    auto = balance.world_capabilities()
    probe.update(auto_weights=auto.weights.tolist(), auto_origin=auto.origin)
    check(auto.weights.tolist() == [1.0] * nproc,
          f"mp_balance: the default world's weights {auto.weights.tolist()} (probes "
          f"{probe['capabilities']}) on equal hardware")
    runs = {}
    for mode in ("weighted", "equal"):
        weighted = mode == "weighted"
        set_config(capability_sharding="auto" if weighted else "off",
                   rank_capability=pinned_map(nproc) if weighted else "", fleet_stats="off")
        balance.reset()
        src = balance.local_sources(x, chunk_rows=chunk)
        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        km_summary = {}
        t0 = time.perf_counter()
        stream_ops.begin_fit(src)
        c, n_iter, cost, _ = stream_ops.lloyd_run_streamed(src, c0, cfg["stream_iter"], 1e-4,
                                                           "highest", device=dev)
        stream_ops.end_fit(km_summary)
        km_wall = time.perf_counter() - t0
        km_launch = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        local_chunks = -(-src.n_rows // chunk)
        check(km_launch[kmeans_kernel.KERNEL] == (local_chunks * (n_iter + 1) if on_card else 0)
              and km_launch[ring_kernel.KERNEL] == (n_iter + 1 if on_card else 0),
              f"mp_balance {mode} kmeans: launches {km_launch}, {local_chunks} chunks here")
        pca_kernel.reset_launches()
        ring_kernel.reset_launches()
        psrc = balance.local_sources(px, chunk_rows=chunk)
        pfit = PCA(k=pk).fit(psrc)
        p_launch = {**pca_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        p_chunks = -(-psrc.n_rows // chunk)
        check(p_launch[pca_kernel.KERNEL] == (2 * p_chunks if on_card else 0)
              and p_launch[ring_kernel.KERNEL] == (2 if on_card else 0),
              f"mp_balance {mode} pca: launches {p_launch}, {p_chunks} chunks here")
        als_kernel.reset_launches()
        am = ALS(rank=a["rank"], max_iter=a["max_iter"], reg_param=a["reg"], alpha=a["alpha"],
                 implicit_prefs=True).fit(u[sl], i[sl], r[sl], n_users=a["n_users"],
                                          n_items=a["n_items"])
        a_launch = dict(als_kernel.LAUNCHES)
        blocks = {"kmeans": km_summary["balance"], "pca": pfit.summary["balance"],
                  "als": am.summary["balance"]}
        mp_same(f"mp_balance {mode} balance blocks",
                json.dumps(blocks, sort_keys=True).encode())
        runs[mode] = {"centers": c.cpu().numpy(), "cost": float(cost), "n_iter": n_iter,
                      "pca": (pfit.components_, pfit.explained_variance_),
                      "als": am, "blocks": blocks,
                      "extents": src.plan.extents(), "km_wall_s": km_wall,
                      "km_launches": km_launch, "pca_launches": p_launch,
                      "als_launches": a_launch,
                      "als_iters_per_s": a["max_iter"]
                      / am.summary["timings"].as_dict()["als_iterations"]}
    set_config(capability_sharding="auto", rank_capability="")
    w, e = runs["weighted"], runs["equal"]
    for mode, tag in (("weighted", "w"), ("equal", "e")):
        _mp_save(out, rank, f"balance_als_{tag}_u", runs[mode]["als"].user_factors_)
        _mp_save(out, rank, f"balance_als_{tag}_i", runs[mode]["als"].item_factors_)
    raw = np.asarray([1.0 if p % 2 == 0 else 0.5 for p in range(nproc)])
    want_ext, _ = balance.plan_extents(n, chunk, raw / raw.mean())
    check(w["extents"] == want_ext and e["extents"] != want_ext,
          f"mp_balance: weighted extents {w['extents']}, planned {want_ext}")
    off = w["blocks"]["als"]["offsets"]
    check(off is not None and off[1] - off[0] > off[2] - off[1]
          and e["blocks"]["als"]["offsets"] is None,
          f"mp_balance: block ALS offsets {off} (equal {e['blocks']['als']['offsets']})")
    errs = {"kmeans_centers": factor_rel_err(w["centers"], e["centers"]),
            "kmeans_cost": abs(w["cost"] - e["cost"]) / abs(e["cost"]),
            "pca_components": sign_err(w["pca"][0], e["pca"][0]),
            "pca_ratios": float(np.max(np.abs(w["pca"][1] - e["pca"][1]))),
            "als_pred": pred_rel_err(w["als"], e["als"], a["n_users"], dev)}
    # the factors' largest elementwise difference, beside
    errs_factor = {"als_user_max": factor_rel_err(w["als"].user_factors_,
                                                  e["als"].user_factors_),
                   "als_item_max": factor_rel_err(w["als"].item_factors_,
                                                  e["als"].item_factors_)}
    check(w["n_iter"] == e["n_iter"] and max(v for k, v in errs.items() if k != "als_pred")
          <= 1e-5, f"mp_balance: weighted against equal shares {errs}, iterations "
          f"{w['n_iter']} / {e['n_iter']}")
    # other user blocks add each item's f32 partials in another grouping,
    # which the implicit solve at alpha 40 magnifies over ten iterations:
    # held to the gate of every block ALS whose blocks differ from its
    # reference's (als_block_fit, als_block_2d, mp_als: 1e-4 in prediction
    # space), the value reported
    check(errs["als_pred"] <= 1e-4,
          f"mp_balance: weighted block ALS {errs['als_pred']:.3g} from equal shares")
    # the drill starts from the table's first k rows, far enough from the
    # blob centres that the loop does not converge before max_iter
    drill = mp_balance_drill(cfg, dev, rank, nproc, x, x[:k].copy())
    v = {"processes": nproc, "pinned": pinned_map(nproc), "table": [n, d], "chunk_rows": chunk,
         "extents": {"weighted": w["extents"], "equal": e["extents"]},
         "als_offsets": {"weighted": off, "equal": e["blocks"]["als"]["offsets"]},
         "weighted_vs_equal": errs, "weighted_vs_equal_factor_max": errs_factor,
         "kmeans_wall_s": {m: runs[m]["km_wall_s"] for m in runs},
         "als_iters_per_s": {m: runs[m]["als_iters_per_s"] for m in runs},
         "launches": {m: {"kmeans": runs[m]["km_launches"], "pca": runs[m]["pca_launches"],
                          "als": runs[m]["als_launches"]} for m in runs},
         "balance_blocks": w["blocks"], "probe": probe, "drill": drill}
    emit("mp_balance", v)
    return v


def mp_balance_drill(cfg, dev, rank, nproc, x, c0):
    """The straggler drill: capabilities pinned equal, process 1's rows
    slowed (a sleep a chunk), the rollups armed, rebalance_threshold 1.3
    and rebalance_patience 2; the streamed Lloyd loop from ``c0``.  The
    controller must re-plan by pass ``patience + 1``; K1's
    launches must equal this process's chunks summed over the passes'
    extents.  Returns each pass's walls, skew ratios and the re-plans."""
    chunk, patience = cfg["chunk_rows"], 2
    set_config(rank_capability="1.0", fleet_stats="on", rebalance_threshold=1.3,
               rebalance_patience=patience)
    balance.reset()
    try:
        src = balance.local_sources(SlowRows(x, cfg["drill_sleep_s"] if rank == 1 else 0.0),
                                    chunk_rows=chunk)
        start = src.plan.extents()
        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        summary = {}
        t0 = time.perf_counter()
        stream_ops.begin_fit(src)
        _, n_iter, _, _ = stream_ops.lloyd_run_streamed(src, c0, cfg["drill_iter"], 0.0,
                                                        "highest", device=dev)
        window = fleet.last_window()
        stream_ops.end_fit(summary)
        wall = time.perf_counter() - t0
        launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    finally:
        set_config(rank_capability="", fleet_stats="auto", rebalance_threshold=1.5,
                   rebalance_patience=3)
        balance.reset()
    replans = summary["balance"]["replans"]
    check(bool(replans) and replans[0]["pass"] <= patience + 1
          and replans[0]["slowest_rank"] == 1,
          f"mp_balance drill: re-plans {replans}, expected one by pass {patience + 1}")
    rows = [rec["frames"][rank][fleet.FRAME_FIELDS.index("rows")] for rec in window]
    chunks = int(sum(-(-int(r_) // chunk) for r_ in rows))
    check(launches[kmeans_kernel.KERNEL] == (chunks if dev.type == "cuda" else 0),
          f"mp_balance drill: K1 {launches[kmeans_kernel.KERNEL]}, chunks staged {chunks}")
    mp_same("mp_balance drill", json.dumps(summary["balance"], sort_keys=True).encode())
    walls = [[rec["frames"][p][0] for p in range(nproc)] for rec in window]
    col = fleet.FRAME_FIELDS.index("kernel_dispatch_s")
    dispatch = [[rec["frames"][p][col] for p in range(nproc)] for rec in window]
    check(dev.type != "cuda" or min(dispatch[-1]) > 0.0,
          f"mp_balance drill: the frames' kernel_dispatch_s {dispatch[-1]}")
    return {"sleep_s_a_chunk": cfg["drill_sleep_s"], "patience": patience, "threshold": 1.3,
            "kernel_dispatch_s": dispatch,
            "start_extents": start, "final_extents": summary["balance"]["extents"],
            "passes": len(window), "pass_walls_s": walls,
            "pass_wall_max_s": [max(p) for p in walls],
            "skew_ratios": [rec["skew_ratio"] for rec in window], "replans": replans,
            "launches": launches, "wall_s": wall, "num_iter": n_iter,
            "fleet": summary["fleet"]}


def mp_divergence(cfg, dev, rank):
    """World "c": a streamed K-Means under the collective sanitizer where
    process 1 issues one extra barrier before the fit's first collective.
    Every process must raise CollectiveDivergenceError there, naming both
    ops, well inside the collective timeout."""
    from oap_mllib_tpu_torch.utils import sanitizers

    n, d = cfg["div_rows"], 16
    x = np.random.default_rng(rank).normal(size=(n, d)).astype(np.float32)
    real = collective.process_allgather
    planted = {"done": rank != 1}

    def extra(arrays):
        if not planted["done"]:
            planted["done"] = True
            collective.barrier()
        return real(arrays)

    set_config(sanitizers="collective", flight_recorder=4096)
    collective.process_allgather = extra
    t0 = time.perf_counter()
    err = None
    try:
        KMeans(k=8, max_iter=3, seed=0, init_mode="random", device=str(dev)).fit(
            ChunkSource.from_array(x, n // 4))
    except sanitizers.CollectiveDivergenceError as e:
        err = str(e)
    finally:
        collective.process_allgather = real
        set_config(sanitizers="", flight_recorder=0)
    seconds = time.perf_counter() - t0
    check(err is not None, "mp_divergence: the planted collective raised nothing")
    return {"error": err, "seconds": seconds,
            "timeout_s": float(config.get_config().collective_timeout)}


MP_STATE = {}


def mp_worker(argv) -> int:
    """One process of a world: join, run the world's phases, print one
    ``MP_RESULT`` line."""
    from oap_mllib_tpu_torch.parallel import bootstrap

    rank, nproc, port, world, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4]
    flags = set(argv[5:])
    rehearse, mesh = "--rehearse" in flags, "--mesh" in flags
    MP_STATE["mesh"] = mesh
    cfg = MP_TINY if rehearse else MP_FULL
    set_config(device=mp_local_devices(world, rank, mesh, rehearse), collective_timeout=600.0)
    bootstrap.initialize_distributed(f"127.0.0.1:{port}", nproc, rank, launcher_store=True)
    dev = resolve_devices()[0]
    res = {"rank": rank, "world": world, "layout": bootstrap.world_layout()}
    try:
        if world == "a" and "--tuning-only" in flags:
            res["mp_tuning"] = mp_tuning(cfg, dev, rank, nproc, out)
        elif world == "a":
            res["mp_ring"] = mp_ring(cfg, dev, rank, nproc)
            res["mp_kmeans"] = [mp_kmeans(cfg, dev, rank, nproc, 1, out, "k-means||")]
            res["mp_pca"] = [mp_pca(cfg, dev, rank, nproc, 1, out)]
            res["mp_stream"] = mp_stream(cfg, dev, rank, nproc, out)
            res["mp_balance"] = mp_balance(cfg, dev, rank, nproc, out)
            res["mp_tuning"] = mp_tuning(cfg, dev, rank, nproc, out)
        elif world == "c":
            res["mp_divergence"] = mp_divergence(cfg, dev, rank)
        elif world == "k":
            # the survivor leaves at once (its peer is gone: no teardown)
            from oap_mllib_tpu_torch.utils import recovery

            res["mp_ring_kill"] = mp_ring_kill(dev, rank, nproc)
            print("MP_RESULT " + json.dumps(res), flush=True)
            recovery.exit_now(0)
        else:
            res["mp_ring_members"] = mp_ring_members(dev, rank, nproc)
            res["mp_kmeans"] = [mp_kmeans(cfg, dev, rank, nproc, 2, out, "random")]
            res["mp_pca"] = [mp_pca(cfg, dev, rank, nproc, 2, out)]
            res["mp_als"] = mp_als(cfg, dev, rank, nproc, out)
            res["mp_block_stream"] = mp_block_stream(cfg, dev, rank, nproc, out)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        bootstrap.shutdown()
    print("MP_RESULT " + json.dumps(res), flush=True)
    return 0


def run_world(world, nproc, out, flags, killed=(), timeout_s=MP_TIMEOUT_S):
    """Spawn a world of ``nproc`` worker processes and collect their
    results; every process is stopped before this returns.  This process
    hosts the world's store on a port the kernel assigns and holds it
    until the workers end, so two runs on one machine never meet.  The
    ranks in ``killed`` must end by SIGKILL and print no result; the
    world must end within ``timeout_s``."""
    import datetime

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, nproc, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                               str(r), str(nproc), str(store.port), world, out, *flags],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        raise Failed(f"world {world}: the workers did not end within {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if not line.startswith("MP_RESULT "):
                print(f"[{world}{r}] {line}", flush=True)
        if r in killed:
            check(p.returncode == -9, f"world {world}: worker {r} exited {p.returncode}, "
                                      "expected its SIGKILL")
            continue
        if p.returncode != 0:
            raise Failed(f"world {world}: worker {r} exited {p.returncode}")
        got = [ln for ln in text.splitlines() if ln.startswith("MP_RESULT ")]
        check(bool(got), f"world {world}: worker {r} printed no result")
        results.append(json.loads(got[-1][len("MP_RESULT "):]))
    return results, time.perf_counter() - t0


def _mp_load(out, name, nproc):
    """A saved array, asserted identical on every process."""
    arrays = [np.load(os.path.join(out, f"rank{r}_{name}.npy")) for r in range(nproc)]
    check(all(np.array_equal(a, arrays[0]) for a in arrays), f"{name}: processes differ")
    return arrays[0]


def als_f64(data, cfg, seed, dev, chunk=1 << 21):
    """The implicit ALS of ``cfg`` in float64 on ``dev``, a plain reference
    independent of the port's routes: als_np's normal equations (A by
    ``alpha |r|`` on every edge, b by ``1 + alpha |r|`` and the ALS-WR
    count on positive ones, plus the other side's Gram) summed by
    ``index_add_`` and solved by ``torch.linalg.cholesky_ex``, rows with
    no positive rating zero; from the fits' own start (the item factors
    ``init_factors(n_items, rank, seed + 1)``).  Returns the (user, item)
    factors, float64 numpy."""
    users, items, ratings = data
    r, alpha, reg = cfg["rank"], cfg["alpha"], cfg["reg"]
    f64 = torch.float64
    u = torch.as_tensor(users, dtype=torch.int64, device=dev)
    i = torch.as_tensor(items, dtype=torch.int64, device=dev)
    c = torch.as_tensor(ratings, dtype=f64, device=dev)
    eye = torch.eye(r, dtype=f64, device=dev)

    def half(dst, src, n_dst, f):
        a = torch.zeros((n_dst, r * r), dtype=f64, device=dev)
        b = torch.zeros((n_dst, r), dtype=f64, device=dev)
        n = torch.zeros((n_dst,), dtype=f64, device=dev)
        for e0 in range(0, len(dst), chunk):
            d, ys, cc = dst[e0:e0 + chunk], f[src[e0:e0 + chunk]], c[e0:e0 + chunk]
            pos = (cc > 0).to(f64)
            a.index_add_(0, d, ((alpha * cc.abs())[:, None, None] * ys[:, :, None]
                                * ys[:, None, :]).reshape(-1, r * r))
            b.index_add_(0, d, ((1.0 + alpha * cc.abs()) * pos)[:, None] * ys)
            n.index_add_(0, d, pos)
        a = a.reshape(n_dst, r, r) + (f.T @ f)[None] + reg * n[:, None, None] * eye[None]
        chol, info = torch.linalg.cholesky_ex(a)
        x = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
        return torch.where(((n > 0) & (info == 0))[:, None], x, 0.0)

    y = torch.as_tensor(als_np.init_factors(cfg["n_items"], r, seed + 1), dtype=f64, device=dev)
    for _ in range(cfg["max_iter"]):
        x = half(u, i, cfg["n_users"], y)
        y = half(i, u, cfg["n_items"], x)
    return x.cpu().numpy(), y.cpu().numpy()


def balance_f64_witness(cfg, data, out, nproc, dev):
    """mp_balance's weighted and equal-share block ALS (every process's
    factors equal) each against the float64 fit of the same ratings, in
    prediction space: how far each f32 fit lies from the exact answer
    beside how far the two lie apart.  The equal-share fit must lie
    within 1e-4 of it (the block ALS gate) and the weighted one within
    1e-5, or no farther than twice the equal-share fit."""
    from types import SimpleNamespace

    t0 = time.perf_counter()
    uf, itf = als_f64(data, cfg, 0, dev)
    ref = SimpleNamespace(user_factors_=uf, item_factors_=itf)
    fits = {mode: SimpleNamespace(user_factors_=_mp_load(out, f"balance_als_{tag}_u", nproc),
                                  item_factors_=_mp_load(out, f"balance_als_{tag}_i", nproc))
            for mode, tag in (("weighted", "w"), ("equal", "e"))}
    v = {f"{mode}_vs_f64": pred_rel_err(m, ref, cfg["n_users"], dev)
         for mode, m in fits.items()}
    v["weighted_vs_equal"] = pred_rel_err(fits["weighted"], fits["equal"], cfg["n_users"], dev)
    v["f64_s"] = time.perf_counter() - t0
    emit("balance_f64", v)
    check(v["equal_vs_f64"] <= 1e-4 and v["weighted_vs_f64"] <= max(2.0 * v["equal_vs_f64"],
                                                                     1e-5),
          f"balance_f64: the weighted block ALS {v['weighted_vs_f64']:.3g} from the float64 "
          f"fit, the equal-share one {v['equal_vs_f64']:.3g}")
    return v


def phase_mp(dev, mesh, rehearse):
    """The fits across processes (worlds "a" and "b"), then each against
    the one-process fit of the same shape in this process."""
    cfg = MP_TINY if rehearse else MP_FULL
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oap_mllib_tpu_torch",
                       "build", "mp_smoke")
    os.makedirs(out, exist_ok=True)
    flags = (["--rehearse"] if rehearse else []) + (["--mesh"] if mesh else [])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n_a = 4 if mesh else 2
    a, wall_a = run_world("a", n_a, out, flags)
    b, wall_b = run_world("b", 2, out, flags)
    c, wall_c = run_world("c", 2, out, flags)
    if dev.type == "cuda":
        # a peer SIGKILLed inside a K5 call: the survivor raises and leaves
        k, wall_k = run_world("k", 2, out, flags, killed=(1,), timeout_s=180)
        emit("mp_ring_kill_world", {"world_wall_s": wall_k,
                                    "survivors": [r["mp_ring_kill"] for r in k]})
    div = [r["mp_divergence"] for r in c]
    for r, v in enumerate(div):
        check("op:process_allgather" in v["error"] and "op:barrier" in v["error"]
              and v["seconds"] < v["timeout_s"],
              f"mp_divergence process {r}: {v['seconds']:.1f} s, {v['error'][:400]}")
    emit("mp_divergence", {"seconds": [v["seconds"] for v in div], "world_wall_s": wall_c,
                           "first_lines": [v["error"].splitlines()[0] for v in div]})
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    x, c0 = blob_rows(n, 0, n, d, k, 0, dev)
    checks = {}
    # K-Means: the one-process mesh fit of each world's shape
    for v, layout_n, model, init in ((a[0]["mp_kmeans"][0], n_a, 1, "k-means||"),
                                     (b[0]["mp_kmeans"][0], 4, 2, "random")):
        devs = mesh_devices(dev, layout_n) if mesh else [dev] * layout_n
        set_config(model_parallel=model)
        try:
            ref = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, init_mode=init,
                         device=",".join(str(q) for q in devs)).fit(x)
        finally:
            set_config(model_parallel=1)
        got = _mp_load(out, v["tag"], n_a if model == 1 else 2)
        c_err = float(np.max(np.abs(got - ref.cluster_centers_)))
        cost_err = abs(v["training_cost"] - ref.summary.training_cost) / ref.summary.training_cost
        check(v["num_iter"] == ref.summary.num_iter,
              f"mp_kmeans {v['mesh']}: {v['num_iter']} iterations, one process "
              f"{ref.summary.num_iter}")
        check(c_err <= 1e-5 and cost_err <= 1e-5,
              f"mp_kmeans {v['mesh']}: centers {c_err:.3g}, cost {cost_err:.3g} from one process")
        one_loop = ref.summary.timings.as_dict()["lloyd_loop"]
        checks[v["tag"]] = {"centers_abs_err": c_err, "cost_rel_err": cost_err,
                            "bit_equal": bool(np.array_equal(got, ref.cluster_centers_)),
                            "one_process_iters_per_s": ref.summary.num_iter / one_loop}
    # PCA: the one-device fit
    (pn, pd), pk = cfg["pca"], cfg["pca_k"]
    px = spectrum_rows(pn, 0, pn, pd, pd, dev)
    one = PCA(k=pk, device=str(dev)).fit(px)
    keep = one.explained_variance_ > 1e-5
    for v, nproc in ((a[0]["mp_pca"][0], n_a), (b[0]["mp_pca"][0], 2)):
        comps = _mp_load(out, v["tag"] + "_components", nproc)
        ratios = _mp_load(out, v["tag"] + "_ratios", nproc)
        comp_err = sign_err(comps[:, keep], one.components_[:, keep])
        ratio_err = float(np.max(np.abs(ratios - one.explained_variance_)))
        check(comp_err <= 1e-4 and ratio_err <= 1e-5,
              f"mp_pca {v['mesh']}: components {comp_err:.3g}, ratios {ratio_err:.3g}")
        checks[v["tag"]] = {"components_err": comp_err, "ratio_err": ratio_err}
    # streamed: the one-process streamed fits
    src = ChunkSource.from_array(x.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
    c1, it1, cost1, _ = stream_ops.lloyd_run_streamed(src, c0, cfg["stream_iter"], 1e-4,
                                                      "highest", device=dev)
    sv = a[0]["mp_stream"]
    sc = _mp_load(out, "stream_centers", n_a)
    scost = float(_mp_load(out, "stream_cost", n_a)[0])
    sc_err = float(np.max(np.abs(sc - c1.cpu().numpy())) / np.max(np.abs(c1.cpu().numpy())))
    scost_err = abs(scost - float(cost1)) / float(cost1)
    check(sv["num_iter"] == it1 and sc_err <= 1e-4 and scost_err <= 1e-5,
          f"mp_stream kmeans: {sv['num_iter']} vs {it1} iterations, centers {sc_err:.3g}, "
          f"cost {scost_err:.3g}")
    psrc = ChunkSource.from_array(px.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
    pone = PCA(k=pk, device=str(dev)).fit(psrc)
    pc = _mp_load(out, "stream_pca_components", n_a)
    pr = _mp_load(out, "stream_pca_ratios", n_a)
    pc_err = sign_err(pc[:, keep], pone.components_[:, keep])
    pr_err = float(np.max(np.abs(pr - pone.explained_variance_)))
    check(pc_err <= 1e-5 and pr_err <= 1e-5,
          f"mp_stream pca: components {pc_err:.3g}, ratios {pr_err:.3g}")
    checks["stream"] = {"centers_rel_err": sc_err, "cost_rel_err": scost_err,
                        "pca_components_err": pc_err, "pca_ratio_err": pr_err}
    del x, px, src, psrc
    # ALS: the one-process four-rank block fit, in prediction space
    acfg = cfg["als"]
    u, i, r = als_data(acfg)
    for v in b[0]["mp_als"]:
        devs = mesh_devices(dev, 4) if mesh else [dev] * 4
        set_config(als_item_layout=v["layout"])
        try:
            ref = ALS(rank=v["rank"], max_iter=acfg["max_iter"], reg_param=acfg["reg"],
                      alpha=acfg["alpha"], implicit_prefs=True,
                      device=",".join(str(q) for q in devs)).fit(
                u, i, r, n_users=acfg["n_users"], n_items=acfg["n_items"])
        finally:
            set_config(als_item_layout="auto")
        uf = np.load(os.path.join(out, f"rank0_{v['tag']}_u.npy"))
        itf = np.load(os.path.join(out, f"rank0_{v['tag']}_i.npy"))
        got = torch.as_tensor(uf, device=dev) @ torch.as_tensor(itf, device=dev).T
        want = (torch.as_tensor(ref.user_factors_[:len(uf)], device=dev)
                @ torch.as_tensor(ref.item_factors_, device=dev).T)
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        check(err <= 1e-4, f"mp_als rank {v['rank']}: prediction rel err {err:.3g}")
        checks[v["tag"]] = {"pred_rel_err": err, "bit_equal": bool(
            np.array_equal(uf, ref.user_factors_[:len(uf)])
            and np.array_equal(itf, ref.item_factors_)),
            "one_process_iters_per_s": acfg["max_iter"]
            / ref.summary["timings"].as_dict()["als_iterations"]}
    # the streamed block ALS: the one-process four-rank streamed fit
    devs = mesh_devices(dev, 4) if mesh else [dev] * 4
    ref = ALS(rank=acfg["rank"], max_iter=acfg["max_iter"], reg_param=acfg["reg"],
              alpha=acfg["alpha"], implicit_prefs=True,
              device=",".join(str(q) for q in devs)).fit(
        als_source(u, i, r), n_users=acfg["n_users"], n_items=acfg["n_items"])
    uf = np.load(os.path.join(out, "rank0_block_stream_u.npy"))
    itf = np.load(os.path.join(out, "rank0_block_stream_i.npy"))
    errs = {"user": factor_rel_err(uf, ref.user_factors_),
            "item": factor_rel_err(itf, ref.item_factors_)}
    check(ref.summary["streamed"] and max(errs.values()) <= 1e-5,
          f"mp_block_stream: factors {errs} from the one-process streamed block fit")
    checks["block_stream"] = {"factor_rel_err": errs, "bit_equal": bool(
        np.array_equal(uf, ref.user_factors_) and np.array_equal(itf, ref.item_factors_)),
        "one_process_iters_per_s": acfg["max_iter"]
        / ref.summary["timings"].as_dict()["als_iterations"]}
    del ref, uf, itf
    bal = a[0]["mp_balance"]
    checks["balance_f64"] = balance_f64_witness(acfg, (u, i, r), out, n_a, dev)
    checks["balance"] = {"weighted_vs_equal": bal["weighted_vs_equal"],
                         "extents": bal["extents"], "als_offsets": bal["als_offsets"],
                         "drill_replans": len(bal["drill"]["replans"]),
                         "drill_first_replan_pass": bal["drill"]["replans"][0]["pass"]}
    result = {"worlds": {"a": {"processes": n_a, "wall_s": wall_a},
                         "b": {"processes": 2, "wall_s": wall_b}},
              "a": a, "b": b, "checks": checks}
    emit("mp", {"checks": checks, "wall_s": {"a": wall_a, "b": wall_b}})
    return result


# -- the resilience ladder and the randomized PCA solver -----------------------------

class armed:
    """``Config.fault_spec`` armed for a ``with`` block, the registry's
    counts fresh, disarmed on the way out."""

    def __init__(self, spec):
        self.spec = spec

    def __enter__(self):
        set_config(fault_spec=self.spec)
        faults.reset()

    def __exit__(self, *exc):
        set_config(fault_spec="")
        faults.reset()


def counted_fit(fit, *tables):
    """``fit()`` with every launch count set to 0 just before and read
    just after; the summary's ``kernels`` must equal the counts."""
    for t in tables:
        for name in t:
            t[name] = 0
    model = fit()
    launches = {name: n for t in tables for name, n in t.items()}
    s = model.summary
    got = s["kernels"] if isinstance(s, dict) else s.kernels
    check(got == launches, f"summary kernels {got} != counters {launches}")
    return model, launches


def ladder_res(model):
    s = model.summary
    return s["resilience"] if isinstance(s, dict) else s.resilience


def phase_ladder(cfg, dev):
    """The resilience ladder on the card at small sizes: each leg a fit
    under a fault spec, counts zeroed just before and read just after,
    against the same fit without the fault.  Returns each leg's
    launches."""
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    narrow, wide = cfg["rows"]
    cuda = dev.type == "cuda"
    x, _, _ = blobs(n, d, k, dev, seed=11)
    host = x.cpu().numpy()
    del x
    set_config(retry_backoff=0.001, retry_deadline=30.0)
    km = kmeans_kernel.LAUNCHES
    out = {}

    def kfit(src, **kw):
        return KMeans(k=k, max_iter=kw.pop("max_iter", it), tol=1e-4, seed=0,
                      device=str(dev), **kw).fit(src)

    # (a) transient faults: three retries, the same bits
    base, base_l = counted_fit(lambda: kfit(ChunkSource.from_array(host, narrow)), km)
    with armed("stream.read:fail=2,prefetch.stage:fail=1"):
        m, launches = counted_fit(lambda: kfit(ChunkSource.from_array(host, narrow)), km)
    res = ladder_res(m)
    check(res["retries"] == 3 and res["faults"] == 3 and res["degradations"] == 0,
          f"ladder (a): {res}")
    check(np.array_equal(m.cluster_centers_, base.cluster_centers_),
          "ladder (a): the retried fit's centers differ from the unfaulted fit's")
    check(launches == base_l and (launches[kmeans_kernel.KERNEL] > 0) == cuda,
          f"ladder (a): launches {launches} vs the unfaulted fit's {base_l}")
    out["a_transient"] = {"resilience": res, "launches": launches, "chunk_rows": narrow}
    emit("ladder_a", out["a_transient"])

    # (b) two device OOMs: halvings /2, /4, the cost of a fit at chunk / 4
    quarter, quarter_l = counted_fit(lambda: kfit(ChunkSource.from_array(host, wide // 4)), km)
    with armed("fit.execute:oom=2"):
        m, launches = counted_fit(lambda: kfit(ChunkSource.from_array(host, wide)), km)
    res = ladder_res(m)
    cost_err = abs(m.summary.training_cost - quarter.summary.training_cost) / abs(
        quarter.summary.training_cost)
    check(res["halvings"] == [2, 4] and res["degradations"] == 2, f"ladder (b): {res}")
    check(cost_err <= 1e-5, f"ladder (b): cost {cost_err:.3g} from the fit at chunk / 4")
    check(launches == quarter_l, f"ladder (b): launches {launches} vs {quarter_l}")
    out["b_halving"] = {"resilience": res, "launches": launches, "cost_rel_err": cost_err,
                        "chunk_rows": wide, "real_oom": real_oom(cfg, dev, kfit)}
    emit("ladder_b", out["b_halving"])

    # (c) a host OOM in an in-memory fit: the spill rung, then the
    # streamed fit of the spill, bit-equal to the same source's fit
    spill_dir = tempfile.mkdtemp(prefix="oap-ladder-spill.")
    try:
        set_config(spill_dir=spill_dir)
        with armed("fit.execute:oomhost=1"):
            m, launches = counted_fit(lambda: kfit(host), km)
        res = ladder_res(m)
        rows = m.summary.route["chunk_rows"]
        ref, ref_l = counted_fit(lambda: kfit(ChunkSource.from_array(host, rows)), km)
        check(res["spilled"] and m.summary.route.get("spilled") and m.summary.streamed
              and res["degradations"] == 1, f"ladder (c): {res}, route {m.summary.route}")
        check(np.array_equal(m.cluster_centers_, ref.cluster_centers_),
              "ladder (c): the spilled fit differs from the source fit")
        check(launches == ref_l, f"ladder (c): launches {launches} vs {ref_l}")
        out["c_spill"] = {"resilience": res, "launches": launches,
                          "spill_files": sorted(os.listdir(spill_dir))}
    finally:
        set_config(spill_dir="")
        shutil.rmtree(spill_dir, ignore_errors=True)
    emit("ladder_c", out["c_spill"])

    # (d) a non-finite iterate under bf16: the precision rung, K1 at the
    # bf16 tier in the unfaulted fit and at highest in the retry
    set_config(compute_precision="bf16")
    try:
        kmeans_kernel.reset_launches()  # the tallies by tier too
        bf, bf_l = counted_fit(lambda: kfit(host), km)
        bf_modes = dict(kmeans_kernel.LAUNCHES_BY_MODE)
        with armed("fit.execute:nan=1"):
            kmeans_kernel.reset_launches()
            m, launches = counted_fit(lambda: kfit(host), km)
        modes = dict(kmeans_kernel.LAUNCHES_BY_MODE)
    finally:
        set_config(compute_precision="f32")
    f32, _ = counted_fit(lambda: kfit(host), km)
    res = ladder_res(m)
    iters = m.summary.num_iter
    check(bf.summary.precision == "bf16" and m.summary.precision == "f32"
          and res["degradations"] == 1 and "[nonfinite]" in res["history"][0],
          f"ladder (d): {res}, precision {m.summary.precision}")
    check(not cuda or (bf_modes["default"] == bf.summary.num_iter and bf_modes["highest"] == 1
                       and modes["default"] == 0 and modes["highest"] == iters + 1),
          f"ladder (d): K1 by tier, bf16 fit {bf_modes}, rung {modes}")
    check(np.array_equal(m.cluster_centers_, f32.cluster_centers_),
          "ladder (d): the f32 retry differs from the f32 fit")
    out["d_precision"] = {"resilience": res, "launches": launches, "by_tier": modes,
                          "bf16_fit_by_tier": bf_modes}
    emit("ladder_d", out["d_precision"])

    # (e) C1: non-finite iterates raise, naming what went non-finite
    bad = host.copy()
    bad[7, 2] = np.nan
    names = {}
    for tag, fit, what in (
            ("kmeans", lambda: kfit(ChunkSource.from_array(bad, wide), max_iter=3,
                                    init_mode="random"), "centroids"),
            ("pca", lambda: PCA(k=2, device=str(dev)).fit(ChunkSource.from_array(
                (np.random.default_rng(0).normal(size=(4096, 16)) * 3e19).astype(np.float32),
                wide)), "Gram")):
        try:
            fit()
        except resilience.NonFiniteError as e:
            names[tag] = str(e)
        check(what in names.get(tag, ""), f"ladder (e): {tag} raised {names.get(tag)!r}")
    out["e_nonfinite"] = names
    emit("ladder_e", names)

    # (f) a persistent device OOM: every halving, then ResilienceError
    # with the history; the plain version (the CPU) never runs
    plain_calls = [0]
    real_plain = kmeans_kernel.lloyd_accumulate_plain

    def spy(*a, **kw):
        plain_calls[0] += 1
        return real_plain(*a, **kw)

    kmeans_kernel.lloyd_accumulate_plain = spy
    history = None
    try:
        kmeans_kernel.reset_launches()
        with armed("fit.execute:oom=*"):
            try:
                kfit(ChunkSource.from_array(host, wide))
            except resilience.ResilienceError as e:
                history = e.history
    finally:
        kmeans_kernel.lloyd_accumulate_plain = real_plain
    expect = resilience.halvings_available(ChunkSource.from_array(host, wide).chunk_rows) + 1
    check(history is not None and len(history) == expect,
          f"ladder (f): history {history}, expected {expect} entries")
    check(not cuda or plain_calls[0] == 0, f"ladder (f): the plain version ran {plain_calls}")
    out["f_exhausted"] = {"history": history, "launches": dict(km),
                          "plain_calls": plain_calls[0]}
    emit("ladder_f", out["f_exhausted"])

    # (g) a streamed ALS fit from a triples source, one read fault
    rng = np.random.default_rng(5)
    a = cfg["als"]
    tri = np.stack([rng.integers(a["n_users"], size=a["nnz"]),
                    np.minimum(rng.zipf(1.3, size=a["nnz"]) - 1, a["n_items"] - 1),
                    rng.random(a["nnz"]) * 4 + 1], axis=1)

    def afit():
        return ALS(rank=a["rank"], max_iter=a["max_iter"], implicit_prefs=True, alpha=40.0,
                   reg_param=0.1, seed=0, device=str(dev)).fit(
            ChunkSource.from_array(tri, 1 << 16))

    ab, ab_l = counted_fit(afit, als_kernel.LAUNCHES)
    with armed("stream.read:fail=1"):
        m, launches = counted_fit(afit, als_kernel.LAUNCHES)
    res = ladder_res(m)
    want = 2 * a["max_iter"] if cuda else 0
    check(res["retries"] == 1 and m.summary["streamed"], f"ladder (g): {res}")
    check(launches[als_kernel.SOLVE] == want and launches[als_kernel.GRAM] == want,
          f"ladder (g): launches {launches}, expected {want} of each")
    check(np.array_equal(m.user_factors_, ab.user_factors_)
          and np.array_equal(m.item_factors_, ab.item_factors_),
          "ladder (g): the retried ALS factors differ from the unfaulted fit's")
    out["g_als"] = {"resilience": res, "launches": launches}
    emit("ladder_g", out["g_als"])
    set_config(retry_backoff=0.05, retry_deadline=30.0)
    return out


def real_oom(cfg, dev, kfit):
    """A real ``torch.cuda.OutOfMemoryError`` (an allocation larger than
    the card) must classify as "oom".  Then a streamed fit of a table
    staged as one chunk (``oom_rows`` x d, so its chunks dominate the
    fit's device memory) under a memory cap
    (``torch.cuda.set_per_process_memory_fraction``) halfway between the
    peaks measured at the full chunk width and at half of it: where the
    cap makes the full width fail, the halving rungs must finish, the
    fit bit-equal to the fit at the width they reached.  Whether the cap
    fires is reported, not required."""
    if dev.type != "cuda":
        return None
    x, _, _ = blobs(cfg["oom_rows"], cfg["d"], cfg["k"], dev, seed=12)
    host = x.cpu().numpy()
    del x
    try:
        torch.empty((1 << 40,), dtype=torch.uint8, device=dev)
        kind = "no error"
    except torch.cuda.OutOfMemoryError as e:
        kind = resilience.classify_fault(e)
    check(kind == resilience.OOM, f"a real CUDA OOM classified as {kind!r}")
    rows = host.shape[0]  # the whole table one chunk: the staged chunks dominate
    peaks = {}
    fits = {}
    for width in (rows, rows // 2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        fits[width] = kfit(ChunkSource.from_array(host, width))
        # the cap bounds what the allocator reserves, but it frees its
        # cached blocks and retries before it raises: what a fit needs
        # is its peak of live allocations
        peaks[width] = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = (peaks[rows] + peaks[rows // 2]) // 2
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        m = kfit(ChunkSource.from_array(host, rows))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
    res = m.summary.resilience
    fired = res["faults"] > 0
    if fired:
        check(all("[oom]" in h and "out of memory" in h.lower() for h in res["history"])
              and res["halvings"] == [2 ** (i + 1) for i in range(len(res["history"]))],
              f"real OOM rung: {res}")
        width = resilience.halved_rows(ChunkSource.from_array(host, rows).chunk_rows,
                                       len(res["halvings"]))
        ref = fits.get(width) or kfit(ChunkSource.from_array(host, width))
        check(np.array_equal(m.cluster_centers_, ref.cluster_centers_),
              f"real OOM rung: the fit differs from the fit at {width} rows")
    return {"classified": kind, "peaks_allocated": {str(w): p for w, p in peaks.items()},
            "cap_bytes": cap, "fired": fired, "resilience": res}


def phase_pca_randomized(cfg, dev, smi):
    """The randomized solver at the full width of the PCA kernel phase
    (2^18 x 1024, k = 16, a decaying spectrum): against eigh on the same
    table, the ratios within 1e-4 relative and every component's
    |cosine| above 1 - 1e-4; two K2 launches a fit, counted just before
    and after; each fit's wall and each solver's own time on the
    covariance (CUDA events)."""
    (n, d), k = cfg["shapes"][-1], cfg["k"]
    x = pca_data(n, d, dev, seed=d + 1)
    fits = {}
    for solver in ("eigh", "randomized"):
        set_config(pca_solver=solver)
        try:
            t0 = time.perf_counter()
            model, launches = counted_fit(lambda: PCA(k=k, device=str(dev)).fit(x),
                                          pca_kernel.LAUNCHES)
            wall = time.perf_counter() - t0
        finally:
            set_config(pca_solver="auto")
        check(model.summary["pca_solver"] == solver, f"pca_randomized: ran {model.summary}")
        check(launches[pca_kernel.KERNEL] == (2 if dev.type == "cuda" else 0),
              f"pca_randomized {solver}: K2 launched {launches}")
        fits[solver] = (model, launches, wall)
    eigh, rand = fits["eigh"][0], fits["randomized"][0]
    ratio_err = float(np.max(np.abs(rand.explained_variance_ - eigh.explained_variance_)
                             / eigh.explained_variance_))
    cos = np.abs(np.einsum("dk,dk->k", rand.components_, eigh.components_))
    check(ratio_err <= 1e-4 and bool(np.all(cos > 1 - 1e-4)),
          f"pca_randomized: ratios {ratio_err:.3g}, cosines {cos.min():.8f}")
    cov, _ = pca_ops.covariance(x, torch.ones(n, device=dev), n)
    reps = 5 if dev.type == "cuda" else 1
    out = {"shape": [n, d], "k": k, "ratio_rel_err": ratio_err,
           "min_abs_cosine": float(cos.min()), "card": smi,
           "eigh_ms": time_ms(lambda: pca_ops.eigh_descending(cov), dev, reps),
           "randomized_ms": time_ms(lambda: pca_ops.topk_eigh_randomized(cov, k), dev, reps)}
    for solver, (model, launches, wall) in fits.items():
        out[solver] = {"wall_s": wall, "phases_s": model.summary["timings"].as_dict(),
                       "launches": launches}
    emit("pca_randomized", out)
    return out


def mp_launches(mp):
    """Each kernel's launches by path in the worlds (process 0's)."""
    a, b = mp["a"][0], mp["b"][0]
    return {
        kmeans_kernel.KERNEL: {f"mp_kmeans {v['tag']} (a process)": v["launches"][
            kmeans_kernel.KERNEL] for v in a["mp_kmeans"] + b["mp_kmeans"]} | {
            "mp_stream kmeans (a process)": a["mp_stream"]["launches"][kmeans_kernel.KERNEL],
            "mp_balance kmeans weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["kmeans"][kmeans_kernel.KERNEL],
            "mp_balance drill (a process)":
                a["mp_balance"]["drill"]["launches"][kmeans_kernel.KERNEL]},
        pca_kernel.KERNEL: {f"mp_pca {v['tag']} (a process)": v["launches"][pca_kernel.KERNEL]
                            for v in a["mp_pca"] + b["mp_pca"]} | {
            "mp_stream pca (a process)": a["mp_stream"]["pca_launches"][pca_kernel.KERNEL],
            "mp_balance pca weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["pca"][pca_kernel.KERNEL]},
        als_kernel.SOLVE: {f"mp_{v['tag']} (a process)": v["launches"][als_kernel.SOLVE]
                           for v in b["mp_als"]} | {
            "mp_block_stream (a process)": b["mp_block_stream"]["launches"][als_kernel.SOLVE],
            "mp_balance als weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["als"][als_kernel.SOLVE]},
        als_kernel.GRAM: {f"mp_{v['tag']} (a process)": v["launches"][als_kernel.GRAM]
                          for v in b["mp_als"]} | {
            "mp_block_stream (a process)": b["mp_block_stream"]["launches"][als_kernel.GRAM],
            "mp_balance als weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["als"][als_kernel.GRAM]},
        ring_kernel.KERNEL: {f"mp_kmeans {v['tag']} (a process)": v["launches"][
            ring_kernel.KERNEL] for v in a["mp_kmeans"] + b["mp_kmeans"]} | {
            "mp_stream kmeans (a process)": a["mp_stream"]["launches"][ring_kernel.KERNEL],
            "mp_stream pca (a process)": a["mp_stream"]["pca_launches"][ring_kernel.KERNEL],
            "mp_balance kmeans weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["kmeans"][ring_kernel.KERNEL],
            "mp_balance pca weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["pca"][ring_kernel.KERNEL],
            "mp_balance drill (a process)":
                a["mp_balance"]["drill"]["launches"][ring_kernel.KERNEL]},
    }


# -- checkpoints, resume and the supervisor ------------------------------------------

CKPT_FULL = {"kmeans": {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "stop": 10,
                        "interval": 5, "kill_interval": 2, "kill_pass": 3},
             "als": {"max_iter": 10, "stop": 5, "interval": 3},
             "pca": {"n": 1 << 20, "d": 128, "k": 16, "chunk_rows": 1 << 16},
             "reshard": {"max_iter": 4, "stop": 2, "blocks": (4, 2)}}
CKPT_TINY = {"kmeans": {"n": 4133, "d": 29, "k": 11, "max_iter": 8, "stop": 4, "interval": 2,
                        "kill_interval": 2, "kill_pass": 3},
             "als": {"max_iter": 4, "stop": 2, "interval": 1},
             "pca": {"n": 3001, "d": 37, "k": 5, "chunk_rows": 1024},
             "reshard": {"max_iter": 4, "stop": 2, "blocks": (4, 2)}}
# the supervised worlds: each process streams its half of the headline
# K-Means table and fits the block ALS on its cut of the ML-25M ratings
SUP_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "chunk_rows": 1 << 16, "km_iter": 6,
            "als": ALS_FULL, "als_iter": 6, "interval": 2, "als_cut": 0.46}
SUP_TINY = {"n": 4096, "d": 29, "k": 11, "chunk_rows": 256, "km_iter": 6, "als": ALS_TINY,
            "als_iter": 6, "interval": 2, "als_cut": 0.46}


def _scratch(name):
    """A fresh directory for ``name`` under the port's build directory (the
    checkout's, listed in .gitignore)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oap_mllib_tpu_torch",
                        "build", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _ck_stats(model):
    s = model.summary
    return s["checkpoint"] if isinstance(s, dict) else s.checkpoint


def ckpt_fit(fit, dev, ckdir, interval, launches):
    """One fit with checkpoints under ``ckdir`` (None: unarmed), every
    count in ``launches`` zeroed just before: (model, wall s, launches,
    restore s)."""
    set_config(checkpoint_dir=ckdir or "", checkpoint_interval=interval)
    for table in launches:
        for name in table:
            table[name] = 0
    restore0 = ckpt_mod.stats()["restore_seconds"]
    sync(dev)
    t0 = time.perf_counter()
    model = fit()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = {name: n for table in launches for name, n in table.items()}
    return model, wall, counts, ckpt_mod.stats()["restore_seconds"] - restore0


def write_ms(ck):
    return 1e3 * ck["write_seconds"] / max(1, ck["writes"])


def ckpt_kmeans(cfg, dev, root):
    """(a) The headline K-Means fit unarmed, then armed (checkpoint every
    ``interval`` iterations), then armed to ``stop`` iterations and
    resumed to ``max_iter``: the resumed centers bit-equal to the armed
    full fit's, equal iterations and cost; K1 launched once per resumed
    iteration plus once per segment's cost pass, and held against its
    plain version at the restored centers."""
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    x = blobs(n, d, k, dev, seed=0)[0]

    def fit(max_iter):
        return lambda: KMeans(k=k, max_iter=max_iter, tol=1e-4, init_mode="k-means||", seed=0,
                              device=str(dev)).fit(x)

    lt = [kmeans_kernel.LAUNCHES]
    # unarmed and armed in turns (unarmed, armed, armed, unarmed)
    unarmed, w_un, l_un, _ = ckpt_fit(fit(cfg["max_iter"]), dev, None, 1, lt)
    armed, w_armed, l_armed, _ = ckpt_fit(fit(cfg["max_iter"]), dev, f"{root}/a_full",
                                          cfg["interval"], lt)
    armed2, w_armed2, _, _ = ckpt_fit(fit(cfg["max_iter"]), dev, f"{root}/a_full2",
                                      cfg["interval"], lt)
    unarmed2, w_un2, _, _ = ckpt_fit(fit(cfg["max_iter"]), dev, None, 1, lt)

    def loops(*models):
        return [m.summary.timings.as_dict()["lloyd_loop"] for m in models]

    part, w_part, _, _ = ckpt_fit(fit(cfg["stop"]), dev, f"{root}/a_part", cfg["interval"], lt)
    resumed, w_res, l_res, restore_s = ckpt_fit(fit(cfg["max_iter"]), dev, f"{root}/a_part",
                                                cfg["interval"], lt)
    ca, cr = _ck_stats(armed), _ck_stats(resumed)
    on = dev.type == "cuda"
    k1 = kmeans_kernel.KERNEL
    check(cr["decision"] == "found" and cr["restored_step"] == part.summary.num_iter,
          f"ckpt kmeans: resumed {cr}")
    check(np.array_equal(resumed.cluster_centers_, armed.cluster_centers_)
          and resumed.summary.num_iter == armed.summary.num_iter
          and resumed.summary.training_cost == armed.summary.training_cost,
          "ckpt kmeans: the resumed fit is not the armed full fit's")
    it_un, it_a = unarmed.summary.num_iter, armed.summary.num_iter
    same = np.array_equal(unarmed.cluster_centers_, armed.cluster_centers_)
    # a fit converging on a segment boundary runs one more (sub-tol) pass
    check((it_a == it_un and same) or it_a == it_un + 1,
          f"ckpt kmeans: armed {it_a} iterations vs unarmed {it_un}, centers equal {same}")
    for tag, model, got in (("armed", armed, l_armed), ("resumed", resumed, l_res)):
        ck = _ck_stats(model)
        ran = model.summary.num_iter - (ck["restored_step"] if ck["decision"] != "fresh" else 0)
        want = ran + ck["writes"] if on else 0  # a cost pass a segment
        check(got[k1] == want and model.summary.kernels == {k1: got[k1]},
              f"ckpt kmeans {tag}: K1 launched {got[k1]} times, expected {want}")
    c = torch.as_tensor(resumed.cluster_centers_, device=dev).contiguous()
    variant = compare(x, torch.ones(n, device=dev), c, "highest", False)
    out = {"shape": [n, d, k], "interval": cfg["interval"], "stop": cfg["stop"],
           "num_iter": {"unarmed": it_un, "armed": it_a, "resumed": resumed.summary.num_iter},
           "wall_s": {"unarmed": [w_un, w_un2], "armed": [w_armed, w_armed2], "part": w_part,
                      "resumed": w_res},
           "lloyd_loop_s": {"unarmed": loops(unarmed, unarmed2), "armed": loops(armed, armed2),
                            "resumed": loops(resumed)[0]},
           "armed_over_unarmed": (w_armed + w_armed2) / (w_un + w_un2),
           "armed_over_unarmed_loop": sum(loops(armed, armed2)) / sum(loops(unarmed, unarmed2)),
           "armed_equal_to_unarmed": same,
           "launches": {"unarmed": l_un[k1], "armed": l_armed[k1], "resumed": l_res[k1]},
           "writes": ca["writes"],
           "bytes_per_write": ca["bytes_written"] / max(1, ca["writes"]),
           "write_ms": write_ms(ca), "restore_ms": 1e3 * restore_s,
           "init_s": {"armed": armed.summary.timings.as_dict()["init_centers"],
                      "resumed": resumed.summary.timings.as_dict()["init_centers"]},
           "k1_vs_plain": variant}
    emit("ckpt_kmeans", out)
    return out


def ckpt_als(cfg, als_cfg, data, dev, root):
    """(b) The implicit ML-25M fit on one device, unarmed, armed (every
    ``interval`` iterations), armed to ``stop`` and continued to
    ``max_iter``: factors bit-equal to the armed full fit's; K3 and K4
    each 2 x (max_iter - stop) launches in the resumed part, each held
    against its plain version at the resumed factors."""
    users, items, ratings = data
    n_users, n_items, r = als_cfg["n_users"], als_cfg["n_items"], als_cfg["rank"]

    def fit(max_iter):
        return lambda: ALS(rank=r, max_iter=max_iter, reg_param=als_cfg["reg"],
                           implicit_prefs=True, alpha=als_cfg["alpha"], seed=0,
                           device=str(dev)).fit(users, items, ratings, n_users, n_items)

    lt = [als_kernel.LAUNCHES]
    unarmed, w_un, _, _ = ckpt_fit(fit(cfg["max_iter"]), dev, None, 1, lt)
    armed, w_armed, l_armed, _ = ckpt_fit(fit(cfg["max_iter"]), dev, f"{root}/b_full",
                                          cfg["interval"], lt)
    ckpt_fit(fit(cfg["stop"]), dev, f"{root}/b_part", cfg["interval"], lt)
    resumed, w_res, l_res, restore_s = ckpt_fit(fit(cfg["max_iter"]), dev, f"{root}/b_part",
                                                cfg["interval"], lt)
    cr, ca = _ck_stats(resumed), _ck_stats(armed)
    check(cr["decision"] == "found" and cr["restored_step"] == cfg["stop"],
          f"ckpt als: resumed {cr}")
    check(np.array_equal(resumed.user_factors_, armed.user_factors_)
          and np.array_equal(resumed.item_factors_, armed.item_factors_),
          "ckpt als: the resumed factors are not the armed full fit's")
    check(np.array_equal(unarmed.user_factors_, armed.user_factors_),
          "ckpt als: the armed fit differs from the unarmed one")
    want = 2 * (cfg["max_iter"] - cfg["stop"]) if dev.type == "cuda" else 0
    check(l_res == {als_kernel.SOLVE: want, als_kernel.GRAM: want},
          f"ckpt als: resumed launches {l_res}, expected {want} of each")
    y = torch.as_tensor(resumed.item_factors_, device=dev)
    side = als_ops.prepare_grouped(*als_ops.build_grouped_edges(users, items, ratings, n_users),
                                   n_users, r, dev)
    a, b, n_reg = side.partials(y, als_cfg["alpha"], True, "f32")
    k3 = solve_check("ckpt K3", a, b, n_reg, als_cfg["reg"], als_kernel.factor_gram(y))
    k4 = gram_check("ckpt K4", y)
    del a, b, n_reg, side
    out = {"rank": r, "interval": cfg["interval"], "stop": cfg["stop"],
           "wall_s": {"unarmed": w_un, "armed": w_armed, "resumed": w_res},
           "armed_over_unarmed": w_armed / w_un,
           "als_iterations_s": {tag: m.summary["timings"].as_dict()["als_iterations"]
                                for tag, m in (("unarmed", unarmed), ("armed", armed),
                                               ("resumed", resumed))},
           "launches": {"armed": l_armed, "resumed": l_res}, "writes": ca["writes"],
           "bytes_per_write": ca["bytes_written"] / max(1, ca["writes"]),
           "write_ms": write_ms(ca), "restore_ms": 1e3 * restore_s,
           "k3_vs_plain": k3, "k4_vs_plain": k4}
    emit("ckpt_als", out)
    return out


def ckpt_pca(cfg, dev, root):
    """(c) The streamed PCA table fitted armed, then again: the second fit
    restores the column sums and runs only the Gram pass (K2 once a
    chunk), its components bit-equal; K2 held against its plain version
    on the staged chunks."""
    n, d, k, rows = cfg["n"], cfg["d"], cfg["k"], cfg["chunk_rows"]
    src = ChunkSource.from_array(pca_data(n, d, dev, seed=d).cpu().numpy(), chunk_rows=rows)
    chunks = -(-n // src.chunk_rows)
    lt = [pca_kernel.LAUNCHES]

    def fit():
        return PCA(k=k, device=str(dev)).fit(src)

    first, w_first, l_first, _ = ckpt_fit(fit, dev, f"{root}/c", 1, lt)
    again, w_again, l_again, restore_s = ckpt_fit(fit, dev, f"{root}/c", 1, lt)
    ck = _ck_stats(again)
    on = dev.type == "cuda"
    check(ck["decision"] == "found", f"ckpt pca: {ck}")
    check(l_first[pca_kernel.KERNEL] == (2 * chunks if on else 0)
          and l_again[pca_kernel.KERNEL] == (chunks if on else 0),
          f"ckpt pca: K2 {l_first} then {l_again}, expected {2 * chunks} then {chunks}")
    check(np.array_equal(first.components_, again.components_)
          and np.array_equal(first.explained_variance_, again.explained_variance_),
          "ckpt pca: the resumed components differ")
    out = {"shape": [n, d], "chunks": chunks,
           "launches": {"first": l_first[pca_kernel.KERNEL],
                        "resumed": l_again[pca_kernel.KERNEL]},
           "wall_s": {"first": w_first, "resumed": w_again},
           "write_ms": write_ms(_ck_stats(first)), "restore_ms": 1e3 * restore_s,
           "k2_vs_plain": pca_chunk_checks(src, dev, "f32")}
    emit("ckpt_pca", out)
    return out


def kill_seed(kill_pass, interval, rate=0.3):
    """A chaos seed whose schedule (``seed:rate:kill:1``, one process)
    leaves the in-memory armed fit's first calls alone (the restore, the
    first segments' passes and cost passes, their writes) and kills it
    at Lloyd pass ``kill_pass``."""
    seg, pos = divmod(kill_pass - 1, interval)
    target = seg * (interval + 1) + pos  # fit.execute call of that pass
    for seed in range(1, 100000):
        st = faults.ChaosState(seed, rate, ["kill"], 1)
        if (not st.decide("ckpt.restore", 0, 0)
                and not any(st.decide("ckpt.write", c, 0) for c in range(seg))
                and not any(st.decide("fit.execute", c, 0) for c in range(target))
                and st.decide("fit.execute", target, 0)):
            return seed
    raise Failed("no chaos seed kills at the pass asked for")


def ckpt_worker(argv) -> int:
    """A child of ``ckpt_kill``: the headline K-Means fit, armed, under
    the given chaos spec; its centers saved beside the checkpoints."""
    mode, ckdir, chaos, rehearse = argv[0], argv[1], argv[2], "--rehearse" in argv
    cfg = (CKPT_TINY if rehearse else CKPT_FULL)["kmeans"]
    dev = resolve_device("cpu" if rehearse else "cuda")
    set_config(checkpoint_dir=ckdir, checkpoint_interval=cfg["kill_interval"], chaos=chaos)
    x = blobs(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)[0]
    kmeans_kernel.reset_launches()
    m = KMeans(k=cfg["k"], max_iter=cfg["max_iter"], tol=1e-4, init_mode="k-means||", seed=0,
               device=str(dev)).fit(x)
    np.save(os.path.join(ckdir, f"centers_{mode}.npy"), m.cluster_centers_)
    print("CKPT_RESULT " + json.dumps({
        "checkpoint": m.summary.checkpoint, "num_iter": m.summary.num_iter,
        "cost": m.summary.training_cost, "launches": dict(kmeans_kernel.LAUNCHES)}), flush=True)
    return 0


def ckpt_kill(cfg, dev, root, rehearse):
    """(d) A child process running the armed headline fit (checkpoint
    every ``kill_interval`` iterations) SIGKILLed by the ``kill`` chaos
    kind at Lloyd pass ``kill_pass`` (exit -9), then relaunched with
    ``resume=auto``: its centers bit-equal to the uninterrupted armed
    fit's, made here."""
    x = blobs(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)[0]
    ref, _, _, _ = ckpt_fit(lambda: KMeans(k=cfg["k"], max_iter=cfg["max_iter"], tol=1e-4,
                                           init_mode="k-means||", seed=0,
                                           device=str(dev)).fit(x),
                            dev, f"{root}/d_ref", cfg["kill_interval"],
                            [kmeans_kernel.LAUNCHES])
    del x
    set_config(checkpoint_dir="")
    seed = kill_seed(cfg["kill_pass"], cfg["kill_interval"])
    ckdir = f"{root}/d_kill"
    os.makedirs(ckdir)
    flags = ["--rehearse"] if rehearse else []

    def child(mode, chaos):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--ckpt-worker", mode,
                            ckdir, chaos, *flags], capture_output=True, text=True, timeout=600)
        return p, time.perf_counter() - t0

    victim, w_victim = child("victim", f"{seed}:0.3:kill:1")
    check(victim.returncode == -9, f"ckpt kill: the victim exited {victim.returncode}: "
                                   f"{victim.stdout[-2000:]}{victim.stderr[-2000:]}")
    resumed, w_resumed = child("resume", "")
    check(resumed.returncode == 0, f"ckpt kill: the relaunch exited {resumed.returncode}: "
                                   f"{resumed.stdout[-2000:]}{resumed.stderr[-2000:]}")
    res = json.loads([ln for ln in resumed.stdout.splitlines()
                      if ln.startswith("CKPT_RESULT ")][-1][len("CKPT_RESULT "):])
    got = np.load(os.path.join(ckdir, "centers_resume.npy"))
    durable = (cfg["kill_pass"] - 1) // cfg["kill_interval"] * cfg["kill_interval"]
    ck = res["checkpoint"]
    check(ck["decision"] == "found" and ck["restored_step"] == durable,
          f"ckpt kill: the relaunch restored {ck}, expected step {durable}")
    check(np.array_equal(got, ref.cluster_centers_) and res["num_iter"] == ref.summary.num_iter
          and res["cost"] == ref.summary.training_cost,
          "ckpt kill: the relaunched fit is not the uninterrupted armed fit's")
    out = {"chaos": f"{seed}:0.3:kill:1", "kill_pass": cfg["kill_pass"],
           "victim_exit": victim.returncode, "restored_step": ck["restored_step"],
           "steps_lost": cfg["kill_pass"] - 1 - durable, "launches_resumed": res["launches"],
           "wall_s": {"victim": w_victim, "resumed": w_resumed}}
    emit("ckpt_kill", out)
    return out


def ckpt_reshard(cfg, als_cfg, data, dev, root):
    """(e) The block ALS on four ranks checkpointed at iteration ``stop``,
    then resumed with ``num_user_blocks=2``: the decision "resharded";
    K3 and K4 each 2 x 2 x (max_iter - stop) launches in the resumed
    part; the factors against the uninterrupted four-block fit (the
    largest |difference| over the largest |value|, and the JAX package's
    elementwise 1e-5 bound, reported).  Two block layouts add the item
    partials in another order, so the gate is 1e-5 or, when larger, the
    distance between the two layouts' uninterrupted fits (the witness:
    the resumed fit ran part of its iterations in each layout)."""
    users, items, ratings = data
    n_users, n_items, r = als_cfg["n_users"], als_cfg["n_items"], als_cfg["rank"]
    layout = ",".join(str(v) for v in mesh_devices(dev, 4))
    before, after = cfg["blocks"]

    def fit(max_iter, blocks):
        return lambda: ALS(rank=r, max_iter=max_iter, reg_param=als_cfg["reg"],
                           implicit_prefs=True, alpha=als_cfg["alpha"], seed=0, device=layout,
                           num_user_blocks=blocks).fit(users, items, ratings, n_users, n_items)

    lt = [als_kernel.LAUNCHES]
    base, w_base, _, _ = ckpt_fit(fit(cfg["max_iter"], before), dev, None, 1, lt)
    other, _, _, _ = ckpt_fit(fit(cfg["max_iter"], after), dev, None, 1, lt)
    witness = max(factor_rel_err(other.user_factors_, base.user_factors_),
                  factor_rel_err(other.item_factors_, base.item_factors_))
    del other
    ckpt_fit(fit(cfg["stop"], before), dev, f"{root}/e", 1, lt)
    got, w_got, l_got, restore_s = ckpt_fit(fit(cfg["max_iter"], after), dev, f"{root}/e", 1,
                                            lt)
    ck = _ck_stats(got)
    check(ck["decision"] == "resharded" and ck["restored_step"] == cfg["stop"],
          f"ckpt reshard: {ck}")
    errs = {}
    for name in ("user_factors_", "item_factors_"):
        a, b = getattr(got, name), getattr(base, name)
        errs[name] = {"max_abs": float(np.max(np.abs(a - b))), "rel": factor_rel_err(a, b),
                      "allclose": bool(np.allclose(a, b, atol=1e-5, rtol=1e-5))}
    gate = max(1e-5, witness)
    check(all(e["rel"] <= gate for e in errs.values()),
          f"ckpt reshard: the resumed factors {errs} lie farther from the uninterrupted fit "
          f"than {gate:.3g} (the layouts' own distance {witness:.3g})")
    want = 2 * after * (cfg["max_iter"] - cfg["stop"]) if dev.type == "cuda" else 0
    check(l_got == {als_kernel.SOLVE: want, als_kernel.GRAM: want},
          f"ckpt reshard: launches {l_got}, expected {want} of each")
    out = {"blocks": [before, after], "stop": cfg["stop"], "max_iter": cfg["max_iter"],
           "errors": errs, "layouts_witness_rel": witness, "gate": gate,
           "jax_bound_holds": all(e["allclose"] for e in errs.values()),
           "launches_resumed": l_got, "restore_ms": 1e3 * restore_s,
           "wall_s": {"uninterrupted": w_base, "resumed": w_got}}
    emit("ckpt_reshard", out)
    return out


def phase_ckpt(cfg, als_cfg, data, dev, rehearse):
    """The checkpointed paths on one card: legs (a)-(e); every
    checkpoint under the port's build directory, removed afterwards."""
    root = _scratch("ckpt_smoke")
    ckpt_mod.reset_stats()
    try:
        out = {"a_kmeans": ckpt_kmeans(cfg["kmeans"], dev, root),
               "b_als": ckpt_als(cfg["als"], als_cfg, data, dev, root),
               "c_pca": ckpt_pca(cfg["pca"], dev, root),
               "d_kill": ckpt_kill(cfg["kmeans"], dev, root, rehearse),
               "e_reshard": ckpt_reshard(cfg["reshard"], als_cfg, data, dev, root)}
    finally:
        set_config(checkpoint_dir="", checkpoint_interval=1, chaos="")
        shutil.rmtree(root, ignore_errors=True)
    return out


def sup_chaos_seed(counts, lo, hi, rate):
    """A chaos seed (``seed:rate:kill:1``) whose schedule fires exactly
    once over process 1's calls in the uninterrupted world (``counts``,
    site -> calls), at ``fit.execute`` call ``lo <= c < hi``, and whose
    next seed (the relaunch's) fires nowhere."""
    # every site's window is widened past the counted calls: a retried
    # join or read in a loaded run calls a site more often than the
    # uninterrupted run did, and no such call may fire
    windows = {site: 2 * counts.get(site, 0) + 8 for site in faults.SITES}

    def fires(seed):
        st = faults.ChaosState(seed, rate, ["kill"], 1)
        return [(site, c) for site, n in windows.items() for c in range(n)
                if st.decide(site, c, 1)]

    for seed in range(1, 400000):
        st = faults.ChaosState(seed, rate, ["kill"], 1)
        hit = [("fit.execute", c) for c in range(lo, hi) if st.decide("fit.execute", c, 1)]
        if len(hit) == 1 and fires(seed) == hit and not fires(seed + 1):
            return seed
    raise Failed("no chaos seed kills process 1 where asked")


def sup_worker(argv) -> int:
    """One process of a supervised world (``--sup-worker rank world
    coord attempt out tag [flags]``): the streamed K-Means over its half
    of the headline table and the block ALS on its cut of the ratings,
    both checkpointed (the supervisor's env), chaos armed in process 1
    only; a victim's recovery error exits 3."""
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.utils import recovery

    rank, world, coord, attempt, out, tag = (int(argv[0]), int(argv[1]), argv[2], int(argv[3]),
                                             argv[4], argv[5])
    flags = set(argv[6:])
    rehearse, mesh = "--rehearse" in flags, "--mesh" in flags
    cfg = SUP_TINY if rehearse else SUP_FULL
    set_config(device=mp_local_devices("a", rank, mesh, rehearse),
               chaos=os.environ.get("OAP_MLLIB_TPU_CHAOS", "") if rank == 1 else "")
    if world > 1:
        bootstrap.initialize_distributed(coord, world, rank)
    dev = resolve_devices()[0]
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    lo, hi = rank * n // world, (rank + 1) * n // world
    acfg = cfg["als"]
    users, items, ratings = als_data(acfg)
    part = als_part(len(users), cfg["als_cut"], rank, world) if world > 1 else slice(None)
    res = {"rank": rank, "world": world, "attempt": attempt}
    for table in (kmeans_kernel.LAUNCHES, als_kernel.LAUNCHES, ring_kernel.LAUNCHES):
        for name in table:
            table[name] = 0
    try:
        x, _ = blob_rows(n, lo, hi, d, k, 0, dev)
        src = ChunkSource.from_array(x.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
        del x
        km = KMeans(k=k, max_iter=cfg["km_iter"], tol=0.0, init_mode="random", seed=0,
                    device=str(dev)).fit(src)
        al = ALS(rank=acfg["rank"], max_iter=cfg["als_iter"], reg_param=acfg["reg"],
                 implicit_prefs=True, alpha=acfg["alpha"], seed=0,
                 num_user_blocks=world if world > 1 else None).fit(
            users[part], items[part], ratings[part], acfg["n_users"], acfg["n_items"])
        # a block fit keeps its factors sharded: every process gathers
        # them together (a collective)
        al_u, al_i = al.user_factors_, al.item_factors_
    except recovery.RecoveryError as e:
        print(f"VICTIM {type(e).__name__} op={e.op} axis={e.axis} "
              f"elapsed_s={e.elapsed_s:.3f}", flush=True)
        recovery.exit_now(3)
    if rank == 0:
        np.save(os.path.join(out, f"{tag}_centers.npy"), km.cluster_centers_)
        np.save(os.path.join(out, f"{tag}_u.npy"), al_u)
        np.save(os.path.join(out, f"{tag}_i.npy"), al_i)
    res.update({
        "kmeans": {"checkpoint": km.summary.checkpoint, "num_iter": km.summary.num_iter,
                   "ladder": km.summary.resilience["ladder"]},
        "als": {"checkpoint": al.summary["checkpoint"],
                "ladder": al.summary["resilience"]["ladder"],
                "route": "block" if al.summary.get("block_parallel") else "one device"},
        "launches": {**kmeans_kernel.LAUNCHES, **als_kernel.LAUNCHES, **ring_kernel.LAUNCHES},
        "chaos_calls": faults.stats().get("chaos", {}).get("calls", {})})
    print("SUP_RESULT " + json.dumps(res), flush=True)
    bootstrap.shutdown()
    return 0


def _sup_results(summary):
    got = []
    for text in summary["outputs"]:
        lines = [ln for ln in text.splitlines() if ln.startswith("SUP_RESULT ")]
        check(bool(lines), f"supervise: a worker printed no result: {text[-3000:]}")
        got.append(json.loads(lines[-1][len("SUP_RESULT "):]))
    return got


def phase_supervise(dev, mesh, rehearse):
    """The supervisor (utils/supervisor.py) over two processes (on the
    one card, or a card each under --mesh), each fitting the streamed
    K-Means and the block ALS with checkpoints and the crash sideband:

    - the uninterrupted world (chaos at rate 0 counts every site's calls);
    - a seeded chaos ``kill`` of process 1 in the ALS after its first
      write: the survivor exits a victim with its crash record, one
      relaunch, and its result bit-equal to the uninterrupted world's;
    - the same kill on every attempt with ``shrink_after=1``: the world
      shrinks to one process, its K-Means within 1e-5 of the
      uninterrupted world's and its ALS against the one-process fit
      (here): within 1e-5 or, when larger, the uninterrupted two-process
      fit's own distance from it (the two layouts add in other orders).

    Each attempt's classification, the detection-to-respawn wall and the
    steps lost are printed."""
    from oap_mllib_tpu_torch.utils import recovery
    from oap_mllib_tpu_torch.utils.supervisor import Supervisor

    cfg = SUP_TINY if rehearse else SUP_FULL
    root = _scratch("sup_smoke")
    flags = (["--rehearse"] if rehearse else []) + (["--mesh"] if mesh else [])
    me = os.path.abspath(__file__)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sups = {}

    def supervised(tag, chaos, **kw):
        env = {**os.environ, "OAP_MLLIB_TPU_CHECKPOINT_DIR": os.path.join(root, tag, "ckpt"),
               "OAP_MLLIB_TPU_CHECKPOINT_INTERVAL": str(cfg["interval"]),
               # the crash records' recorder tail and sanitizer fingerprint
               "OAP_MLLIB_TPU_FLIGHT_RECORDER": "4096",
               "OAP_MLLIB_TPU_SANITIZERS": "collective"}
        sup = Supervisor(lambda rank, world, coord, attempt: [
            sys.executable, me, "--sup-worker", str(rank), str(world), coord, str(attempt),
            root, tag, *flags], 2, os.path.join(root, tag, "sideband"), env=env, chaos=chaos,
            restart_backoff=0.5, attempt_timeout=MP_TIMEOUT_S, grace_s=60.0, **kw)
        t0 = time.perf_counter()
        s = sup.run()
        wall = time.perf_counter() - t0
        sups[tag] = sup
        for att in s["attempts"]:
            print(f"supervise {tag} attempt {att['index']} world {att['world']}: "
                  f"{[e['classification'] for e in att['exits']]} culprit {att['culprit']}",
                  flush=True)
        check(s["ok"], f"supervise {tag}: the world did not complete: {s['attempts']} "
                       f"{[o[-3000:] for o in s['outputs']]}")
        return s, wall

    ref, w_ref = supervised("ref", "0:0.0:kill:1")
    full = _sup_results(ref)
    calls = full[1]["chaos_calls"]
    km_calls = full[1]["kmeans"]["num_iter"] + 1  # Lloyd passes and the cost pass
    als_iter = cfg["als_iter"]
    # an ALS iteration after the first write (at iteration `interval`)
    lo = km_calls + cfg["interval"] + 1
    hi = km_calls + als_iter
    # about one fire expected over the seed search's widened windows
    rate = 1.0 / (2 * sum(calls.values()) + 8 * len(faults.SITES))
    seed = sup_chaos_seed(calls, lo, hi, rate)
    kill_iter = next(c for c in range(lo, hi)
                     if faults.ChaosState(seed, rate, ["kill"], 1).decide("fit.execute", c, 1))
    chaos = f"{seed}:{rate!r}:kill:1"
    run, w_run = supervised("kill", chaos)
    att0 = run["attempts"][0]
    check(run["relaunches"] == 1 and run["shrinks"] == 0 and run["final_world"] == 2,
          f"supervise kill: {run['relaunches']} relaunches, {run['shrinks']} shrinks")
    check([e["classification"] for e in att0["exits"]] == ["peer_abort", "killed"]
          and att0["exits"][1]["returncode"] == -9 and att0["culprit"] == 1,
          f"supervise kill: attempt 0 {att0}")
    # the survivor's whole record (the summary keeps four of its fields)
    record = sups["kill"].attempts[0].exits[0].record or {}
    tail = record.get("flight_recorder") or []
    check(bool(tail) and tail[-1]["kind"] == "crash" and record.get("sanitizer_fingerprint"),
          f"supervise kill: the survivor's crash record carries tail {len(tail)} events, "
          f"fingerprint {record.get('sanitizer_fingerprint')!r}")
    got = _sup_results(run)
    als_ck = got[0]["als"]["checkpoint"]
    reached = kill_iter - km_calls  # ALS iterations finished when the kill fired
    check(als_ck["decision"] == "found", f"supervise kill: the ALS restore {als_ck}")
    same = {name: bool(np.array_equal(np.load(os.path.join(root, f"kill_{name}.npy")),
                                      np.load(os.path.join(root, f"ref_{name}.npy"))))
            for name in ("centers", "u", "i")}
    check(all(same.values()), f"supervise kill: the relaunch is not bit-equal: {same}")
    shrunk, w_shrunk = supervised("shrink", chaos, shrink_after=1)
    check(shrunk["shrinks"] == 1 and shrunk["final_world"] == 1
          and [a["world"] for a in shrunk["attempts"]] == [2, 1],
          f"supervise shrink: {[a['world'] for a in shrunk['attempts']]}")
    one = _sup_results(shrunk)[0]
    check(one["als"]["checkpoint"]["decision"] == "resharded"
          and one["kmeans"]["checkpoint"]["decision"] == "resharded",
          f"supervise shrink: restores {one['kmeans']['checkpoint']} "
          f"{one['als']['checkpoint']}")
    acfg = cfg["als"]
    users, items, ratings = als_data(acfg)
    one_proc = ALS(rank=acfg["rank"], max_iter=cfg["als_iter"], reg_param=acfg["reg"],
                   implicit_prefs=True, alpha=acfg["alpha"], seed=0, device=str(dev)).fit(
        users, items, ratings, acfg["n_users"], acfg["n_items"])
    def load(name):
        return np.load(os.path.join(root, f"{name}.npy"))

    errs = {"centers_vs_two_process": factor_rel_err(load("shrink_centers"),
                                                     load("ref_centers")),
            "user_vs_one_process": factor_rel_err(load("shrink_u"), one_proc.user_factors_),
            "item_vs_one_process": factor_rel_err(load("shrink_i"), one_proc.item_factors_)}
    witness = max(factor_rel_err(load("ref_u"), one_proc.user_factors_),
                  factor_rel_err(load("ref_i"), one_proc.item_factors_))
    als_gate = max(1e-5, witness)
    check(errs["centers_vs_two_process"] <= 1e-5 and errs["user_vs_one_process"] <= als_gate
          and errs["item_vs_one_process"] <= als_gate,
          f"supervise shrink: {errs}, the ALS gate {als_gate:.3g} (the two-process fit's own "
          f"distance {witness:.3g})")
    out = {"processes": 2, "layout": "a card a process" if mesh else "one card",
           "chaos": chaos, "kill_fit_execute_call": kill_iter,
           "als_iterations_reached": reached, "als_restored_step": als_ck["restored_step"],
           "steps_lost": reached - als_ck["restored_step"],
           "survivor_record": {k: v for k, v in record.items()
                               if k not in ("flight_recorder", "telemetry")},
           "survivor_tail": {"events": len(tail), "kinds": sorted({e["kind"] for e in tail}),
                             "last": tail[-3:]},
           "classifications": {tag: [[e["classification"] for e in a["exits"]]
                                     for a in s["attempts"]]
                               for tag, s in (("ref", ref), ("kill", run), ("shrink", shrunk))},
           "detect_to_respawn_s": {"kill": run["recovery_s"], "shrink": shrunk["recovery_s"]},
           "restart_backoff_s": 0.5, "bit_equal": same, "shrink_errors": errs,
           "shrink_als_witness": witness, "shrink_als_gate": als_gate,
           "wall_s": {"ref": w_ref, "kill": w_run, "shrink": w_shrunk},
           "launches": {tag: [r["launches"] for r in _sup_results(s)]
                        for tag, s in (("ref", ref), ("kill", run), ("shrink", shrunk))},
           "recovery_stats": recovery.stats()}
    emit("supervise", out)
    shutil.rmtree(root, ignore_errors=True)
    return out


# -- the observability plane (telemetry) ----------------------------------------

TEL_FULL = {"kmeans": {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20},
            "pca": {"n": 1 << 20, "d": 128, "k": 16}, "als": ALS_FULL,
            "sharded": SHARDED_FULL, "reps": 3,
            "stream": {"n": 1 << 18, "d": 64, "k": 64, "chunk_rows": 1 << 15, "max_iter": 3,
                       "als": LADDER_FULL["als"]}}
TEL_TINY = {"kmeans": {"n": 4133, "d": 29, "k": 11, "max_iter": 5},
            "pca": {"n": 3001, "d": 37, "k": 5}, "als": ALS_TINY,
            "sharded": SHARDED_TINY, "reps": 2,
            "stream": {"n": 4133, "d": 29, "k": 11, "chunk_rows": 1024, "max_iter": 3,
                       "als": LADDER_TINY["als"]}}
TEL_OFF = {"telemetry_log": "", "metrics_port": 0, "flight_recorder": 0, "sanitizers": "",
           "profile_dir": ""}
# the JAX package's GET /healthz keys
HEALTHZ_KEYS = ("capability", "fit", "fleet_passes", "flight_recorder_seq", "last_collective",
                "ladder", "ok", "phase", "rank", "rows_processed", "serving", "step", "world")
# the CUDA functions of each hand-written kernel, as the profiler names them
# (sum_slices_kernel is K2's slice sum; the ALS fit launches no K2)
TRACE_FUNCS = {
    kmeans_kernel.KERNEL: ("csq_kernel", "prep_kernel", "assign_kernel", "assign_wgmma_kernel",
                           "rank_kernel", "scan_sums_kernel", "scan_apply_kernel",
                           "scatter_kernel", "segsum_kernel", "finalize_kernel", "cost_kernel"),
    pca_kernel.KERNEL: ("colsum_kernel", "colsum_finish_kernel", "gram_simt_kernel",
                        "gram_wgmma_kernel", "sum_slices_kernel"),
    als_kernel.SOLVE: ("solve_kernel",),
    als_kernel.GRAM: ("factor_gram_kernel",),
    ring_kernel.KERNEL: ("ring_fold_kernel",),
}
# the walls of the same four fits before the observability plane, the
# first of each in two whole runs of this script on one H100 80GB HBM3 at
# 700 W (its fit, pca_fit, als_fit and sharded_fit phases)
EARLIER_WALLS = {"kmeans": (1.8399, 1.8643), "pca": (0.2589, 0.5038), "als": (4.5082, 4.3873),
              "sharded": (2.2251, 2.5212)}


def _sget(summary, key):
    return summary[key] if isinstance(summary, dict) else getattr(summary, key)


def _kernel_registry():
    """{label: launches} of the ``oap_kernel_launches_total`` family."""
    series = tel_metrics.snapshot().get("oap_kernel_launches_total", {})
    return {lab.split("=", 1)[1]: int(v) for lab, v in series.items()}


def _span_kernels(root):
    """{label: launches} summed over a span tree's ``kernels`` attributes."""
    out = {}
    for _, sp in root.walk():
        for label, n in sp.attrs.get("kernels", {}).items():
            out[label] = out.get(label, 0) + n
    return out


def _trace_kernels(path, kernels):
    """Each kernel's summed device ms and launches in a Chrome trace, and
    the names of the trace's annotations (the fit's spans)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    pats = {k: re.compile(r"(^|[\s:])(" + "|".join(TRACE_FUNCS[k]) + r")(\(|<|$)")
            for k in kernels}
    out = {k: {"ms": 0.0, "events": 0} for k in kernels}
    out["_kernel_events"] = 0
    annotations = set()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel":
            out["_kernel_events"] += 1
            for k, pat in pats.items():
                if pat.search(name):
                    out[k]["ms"] += float(e.get("dur", 0.0)) / 1e3
                    out[k]["events"] += 1
                    break
        elif "annotation" in cat:
            annotations.add(name)
    return out, annotations


def _http(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tel_runs(cfg, dev):
    """The four fits of the phase: ``(name, run, kernel modules)``, each
    run returning ``(arrays to compare, iterations, summary)``."""
    kc, pc, ac, sc = cfg["kmeans"], cfg["pca"], cfg["als"], cfg["sharded"]
    x, _, _ = blobs(kc["n"], kc["d"], kc["k"], dev, seed=0)
    xp = pca_data(pc["n"], pc["d"], dev, seed=pc["d"])
    data = als_data(ac)
    xs = x if (sc["n"], sc["d"]) == (kc["n"], kc["d"]) else blobs(sc["n"], sc["d"], sc["k"],
                                                                  dev, seed=0)[0]
    layout = ",".join(str(q) for q in mesh_devices(dev, sc["data"] * sc["model"]))

    def kmeans():
        m = KMeans(k=kc["k"], max_iter=kc["max_iter"], tol=1e-4, init_mode="k-means||",
                   seed=0, device=str(dev)).fit(x)
        return [m.cluster_centers_], m.summary.num_iter, m.summary

    def pca():
        m = PCA(k=pc["k"], device=str(dev)).fit(xp)
        return [m.components_, m.explained_variance_], None, m.summary

    def als():
        m = ALS(rank=ac["rank"], max_iter=ac["max_iter"], reg_param=ac["reg"],
                implicit_prefs=True, alpha=ac["alpha"], seed=0, device=str(dev)).fit(
            *data, ac["n_users"], ac["n_items"])
        return [m.user_factors_, m.item_factors_], None, m.summary

    def sharded():
        set_config(model_parallel=sc["model"])
        try:
            m = KMeans(k=sc["k"], max_iter=sc["max_iter"], tol=1e-4, seed=0,
                       device=layout).fit(xs)
        finally:
            set_config(model_parallel=1)
        return [m.cluster_centers_], m.summary.num_iter, m.summary

    return [("kmeans", kmeans, [kmeans_kernel]), ("pca", pca, [pca_kernel]),
            ("als", als, [als_kernel]), ("sharded", sharded, [kmeans_kernel, ring_kernel])]


def _tel_one(run, mods, armed, sink):
    """One fit, off or armed, with the kernel counts zeroed just before and
    read just after, the registry's and the span tree's counts beside."""
    set_config(**(armed or TEL_OFF))
    for m in mods:
        m.reset_launches()
    reg0, traces0 = _kernel_registry(), len(profiling.WRITTEN)
    lines0 = _sink_records(sink)
    t0 = time.perf_counter()
    try:
        arrays, n_iter, s = run()
    finally:
        set_config(**TEL_OFF)
    wall = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    reg1 = _kernel_registry()
    root = _sget(s, "timings").root
    return {"arrays": arrays, "n_iter": n_iter, "wall": wall, "launches": launches,
            "registry": {k: reg1.get(k, 0) - reg0.get(k, 0) for k in reg1},
            "spans": _span_kernels(root), "root": root,
            "traces": profiling.WRITTEN[traces0:],
            "sink": _sink_records(sink)[len(lines0):], "summary": s}


def _sink_records(sink):
    if not sink or not os.path.exists(sink):
        return []
    with open(sink) as f:
        return [json.loads(line) for line in f]


def tel_transfer(cfg, dev):
    """(g): the streamed K-Means (k-means|| init: its audited host reads),
    PCA and ALS under the transfer and retrace sanitizers, bit-equal to
    their unarmed fits; a planted ``.item()`` in a streamed consumer body
    raises, and the sync mode is restored after."""
    sc = cfg["stream"]
    x, _, _ = blobs(sc["n"], sc["d"], sc["k"], dev, seed=5)
    src = ChunkSource.from_array(x.cpu().numpy(), chunk_rows=sc["chunk_rows"])
    a = sc["als"]
    rng = np.random.default_rng(9)
    tri = np.stack([rng.integers(a["n_users"], size=a["nnz"]),
                    np.minimum(rng.zipf(1.3, size=a["nnz"]) - 1, a["n_items"] - 1),
                    rng.random(a["nnz"]) * 4 + 1], 1)
    tri_src = ChunkSource.from_array(tri, chunk_rows=1 << 14)

    def fits():
        km = KMeans(k=sc["k"], max_iter=sc["max_iter"], seed=0, init_mode="k-means||",
                    device=str(dev)).fit(src)
        pc = PCA(k=4, device=str(dev)).fit(src)
        al = ALS(rank=a["rank"], max_iter=a["max_iter"], implicit_prefs=True, alpha=40.0,
                 seed=0, device=str(dev)).fit(tri_src, n_users=a["n_users"],
                                              n_items=a["n_items"])
        return {"kmeans": [km.cluster_centers_], "pca": [pc.components_],
                "als": [al.user_factors_, al.item_factors_],
                "streamed": [km.summary.streamed, pc.summary["streamed"],
                             al.summary["streamed"]]}

    plain = fits()
    before = tel_metrics.family_total("oap_sanitizer_transfer_scopes_total")
    set_config(sanitizers="transfer,retrace")
    try:
        guarded = fits()
        scopes = tel_metrics.family_total("oap_sanitizer_transfer_scopes_total") - before
        raised = None
        with Prefetcher(range(3), stage=lambda i: (i, [np.ones((4, 4), np.float32)]),
                        device=dev) as pf:
            try:
                for _, (t,) in pf:
                    t.sum().item()
            except RuntimeError as e:
                raised = str(e)
    finally:
        set_config(sanitizers="")
    mode = torch.cuda.get_sync_debug_mode() if dev.type == "cuda" else 0
    same = {k: all(np.array_equal(p, g) for p, g in zip(plain[k], guarded[k]))
            for k in ("kmeans", "pca", "als")}
    check(all(same.values()) and all(plain["streamed"]),
          f"transfer: guarded streamed fits differ from unarmed ones: {same}")
    check(scopes > 0, "transfer: no consumer body ran under the sanitizer")
    if dev.type == "cuda":
        check(raised is not None and "synchroniz" in raised,
              f"transfer: the planted .item() did not raise ({raised!r})")
    check(mode == 0, f"transfer: the sync debug mode stayed {mode}")
    return {"bit_equal": same, "guarded_bodies": scopes, "planted_raised": raised}


def phase_telemetry(cfg, dev):
    """The observability plane on the four headline fits (module
    docstring, 27): each run off and armed, interleaved, ``reps`` times."""
    out = _scratch("telemetry")
    sink = os.path.join(out, "telemetry.jsonl")
    port = _free_port()
    armed = {"telemetry_log": sink, "metrics_port": port, "flight_recorder": 4096,
             "sanitizers": "collective,transfer,retrace,locks",
             "profile_dir": os.path.join(out, "traces")}
    result = {"port": port}
    health = metrics_text = None
    try:
        for name, run, mods in _tel_runs(cfg, dev):
            runs = {"off": [], "armed": []}
            for _ in range(cfg["reps"]):
                runs["off"].append(_tel_one(run, mods, None, sink))
                runs["armed"].append(_tel_one(run, mods, armed, sink))
            ref = runs["off"][0]
            labels = {k: _tiers.LABELS[k] for k in ref["launches"]}
            for kind, reps in runs.items():
                for r in reps:
                    # (a) bit-equal to the first unarmed fit
                    check(all(np.array_equal(a, b) for a, b in zip(r["arrays"], ref["arrays"]))
                          and r["n_iter"] == ref["n_iter"],
                          f"telemetry {name}: the {kind} fit differs from the unarmed one")
                    # (b) LAUNCHES == registry == span tree, every kernel
                    for k, lab in labels.items():
                        check(r["launches"][k] == r["registry"].get(lab, 0)
                              == r["spans"].get(lab, 0) == ref["launches"][k],
                              f"telemetry {name} {kind}: {k} LAUNCHES {r['launches'][k]}, "
                              f"registry {r['registry'].get(lab, 0)}, spans "
                              f"{r['spans'].get(lab, 0)}")
            expect = [k for k, n in ref["launches"].items() if n > 0]
            check(bool(expect) or dev.type != "cuda", f"telemetry {name}: no kernel launched")
            kern_ms, spans_seen, seen = {k: [] for k in expect}, set(), []
            for r in runs["armed"]:
                # (d) one record per span of the tree and one snapshot a fit
                recs = r["sink"]
                root = r["root"]
                n_spans = sum(1 for _ in root.walk())
                got = [x for x in recs if x["type"] == "span" and x["fit"] == root.name]
                mets = [x for x in recs if x["type"] == "metrics" and x.get("fit") == root.name]
                check(len(got) == n_spans and len(mets) == 1,
                      f"telemetry {name}: sink holds {len(got)} span records of {n_spans} "
                      f"spans and {len(mets)} snapshots")
                # (e) the profiler traces name each kernel of the path
                check(len(r["traces"]) == 1, f"telemetry {name}: traces {r['traces']}")
                ms, ann = _trace_kernels(r["traces"][0], expect)
                spans_seen |= ann
                seen.append(ms["_kernel_events"])
                for k in expect:
                    if ms[k]["events"]:
                        kern_ms[k].append(ms[k]["ms"])
                for path in r["traces"]:
                    os.remove(path)
            # the tracer has dropped a whole session's kernels on the card
            # (profile_calls retries for it): one trace of three must name
            # each kernel, and the count of those that did is printed
            for k in expect:
                check(bool(kern_ms[k]), f"telemetry {name}: no armed fit's trace names {k} "
                                        f"(kernel events a trace: {seen})")
            phases = {c.name for c in ref["root"].children if c.count}
            check(bool(phases & spans_seen),
                  f"telemetry {name}: the trace's annotations {sorted(spans_seen)[:20]} "
                  f"name none of the phases {sorted(phases)}")
            off_w = sorted(r["wall"] for r in runs["off"])
            arm_w = sorted(r["wall"] for r in runs["armed"])
            off_med, arm_med = float(np.median(off_w)), float(np.median(arm_w))
            v = {"launches": ref["launches"], "labels": labels,
                 "walls_s": {"off": [r["wall"] for r in runs["off"]],
                             "armed": [r["wall"] for r in runs["armed"]]},
                 "median_s": {"off": off_med, "armed": arm_med},
                 "armed_over_off": arm_med / off_med,
                 "earlier_first_fit_walls_s": EARLIER_WALLS[name],
                 "kernel_device_ms": {k: float(np.median(v_)) for k, v_ in kern_ms.items()},
                 "traces_naming_the_kernel": {k: len(v_) for k, v_ in kern_ms.items()},
                 "trace_kernel_events": seen,
                 "kernel_share_of_armed_wall": {k: float(np.median(v_)) / 1e3 / arm_med
                                                for k, v_ in kern_ms.items()},
                 "phases_s_off": runs["off"][-1]["root"].flat(),
                 "phases_traced": sorted(phases & spans_seen),
                 "progcache": _sget(runs["armed"][-1]["summary"], "progcache"),
                 "sanitizers": _sget(runs["armed"][-1]["summary"], "sanitizers")}
            emit(f"telemetry_{name}", v)
            result[name] = v
            del runs
        # (c) the live endpoint after the armed fits, armed
        set_config(**armed)
        metrics_text = _http(port, "/metrics")
        health = json.loads(_http(port, "/healthz"))
        kernel_fams = (("oap_kernel_launches_total", "oap_kernel_dispatch_seconds")
                       if dev.type == "cuda" else ())
        for fam in ("oap_fit_total", "oap_progcache_hits_total", "oap_progcache_misses_total",
                    *kernel_fams):
            check(f"# TYPE {fam} " in metrics_text, f"telemetry: /metrics lacks {fam}")
        check(sorted(health) == sorted(HEALTHZ_KEYS) and health["flight_recorder_seq"] >= 0,
              f"telemetry: /healthz {health}")
        set_config(**TEL_OFF)
        # the payload's keys, not the payload: no line but the last may
        # hold an ok flag
        result["endpoint"] = {"metrics_families": sum(
            1 for ln in metrics_text.splitlines() if ln.startswith("# TYPE")),
            "healthz_keys": sorted(health),
            "healthz_flight_recorder_seq": health["flight_recorder_seq"]}
        result["transfer"] = tel_transfer(cfg, dev)
    finally:
        set_config(**TEL_OFF)
        fleet.stop_server()
    emit("telemetry", {k: v for k, v in result.items()
                       if k in ("port", "endpoint", "transfer")})
    # the phase's streams outlive its scratch: the trace merger of 32
    # reads them
    if os.path.exists(sink):
        shutil.copyfile(sink, tel_sink_path())
    shutil.rmtree(out, ignore_errors=True)
    return result


def tel_sink_path():
    """Where phase 27 leaves its JSON-lines sink (the port's build
    directory, listed in .gitignore)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "oap_mllib_tpu_torch",
                        "build", "telemetry_phase27.jsonl")


def tel_worker(argv) -> int:
    """The child of :func:`phase_telemetry_child`: phase 27 in a process of
    its own, its launches on one ``TEL_RESULT`` line."""
    rehearse = "--rehearse" in argv
    dev = resolve_device("cpu" if rehearse else "cuda")
    try:
        res = phase_telemetry(TEL_TINY if rehearse else TEL_FULL, dev)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print("TEL_RESULT " + json.dumps({fit: {"launches": res[fit]["launches"]}
                                      for fit in ("kmeans", "pca", "als", "sharded")}),
          flush=True)
    return 0


def phase_telemetry_child(dev, rehearse):
    """Phase 27 of the full run, in a child process: every torch.profiler
    session of this process after the phase's twelve traces recorded no
    CUDA kernel on the card, and the phase's traces after the earlier
    phases' sessions held none of the PCA fit's; a fresh process traces
    all of them (the kernels the child launches are its own, and the
    build it loads is this run's)."""
    flags = ["--rehearse"] if rehearse else []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--tel-worker", *flags],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                       timeout=MP_TIMEOUT_S)
    for line in p.stdout.splitlines():
        if not line.startswith(("TEL_RESULT ", "USDT:")):
            print(line, flush=True)
    check(p.returncode == 0, f"telemetry: the child exited {p.returncode}")
    got = [ln for ln in p.stdout.splitlines() if ln.startswith("TEL_RESULT ")]
    check(bool(got), "telemetry: the child printed no result")
    return json.loads(got[-1][len("TEL_RESULT "):])


# -- serving and online updates (28) -------------------------------------------

SERVE_FULL = {"kmeans": {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20},
              "requests": 200, "max_rows": 4096, "many": 16, "slab": 1 << 16,
              "pca": {"n": 1 << 20, "d": 128, "k": 16}, "chunk_rows": 1 << 16,
              "pca_delta_chunks": 4, "topk": 10, "sweep_sample": 4096,
              "bench_sweep": {"n_users": 1_000_000, "n_items": 256, "rank": 16},
              "foldin_users": 10_000, "foldin_span": 10_500, "foldin_per_user": 6,
              "foldin_batch": 2048, "delta_rows": 1 << 18}
SERVE_TINY = {"kmeans": {"n": 4133, "d": 29, "k": 11, "max_iter": 5},
              "requests": 20, "max_rows": 256, "many": 16, "slab": 2048,
              "pca": {"n": 3001, "d": 37, "k": 5}, "chunk_rows": 512,
              "pca_delta_chunks": 2, "topk": 10, "sweep_sample": 256,
              "bench_sweep": {"n_users": 5000, "n_items": 64, "rank": 16},
              "foldin_users": 30, "foldin_span": 33, "foldin_per_user": 6,
              "foldin_batch": 7, "delta_rows": 2048,
              # a base that dominates the delta and converges, as ML-25M's
              # does: the refit bound holds only there (the JAX package's)
              "als": dict(ALS_TINY, n_users=3000, nnz=100_000, max_iter=10)}
# ids against a float64 top-k: a row is compared where every gap between
# its 11 best float64 scores exceeds this share of its best |score|
SWEEP_TIE_RTOL = 1e-5
# the partial_fit centers against the plain K1's fold, max |diff| over
# max |value|
PARTIAL_FIT_RTOL = 1e-5
# a fold-in against a refit on base plus delta, in prediction space
# (the JAX package's documented bound)
FOLDIN_REFIT_RTOL = 0.15


def _armed_fault(spec):
    set_config(fault_spec=spec)
    faults.reset()


def _f64_labels(x, c):
    """Nearest center of each row in float64 numpy."""
    x = np.asarray(x, np.float64)
    c = np.asarray(c, np.float64)
    d2 = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None, :]
    return np.argmin(d2, axis=1)


def serve_kmeans_storm(cfg, slab, model, dev, rng):
    """(a) the headline K-Means served: warmup, a storm of jittered
    requests from the host ``slab`` of the blobs' first rows, each
    bit-equal to model.predict; labels against float64; no program-cache
    miss and no build after the warmup; predict_many."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.serving import batcher
    from oap_mllib_tpu_torch.utils import progcache

    ref = _f64_labels(slab, model.cluster_centers_)
    h = serving.serve(model)
    t0 = time.perf_counter()
    buckets = h.warmup(cfg["max_rows"])
    warm_s = time.perf_counter() - t0
    misses = progcache.stats()["misses"]
    builds = batcher.xla_snapshot()
    pad0 = serving.serving_summary()["pad_rows"]
    sizes = rng.integers(1, cfg["max_rows"] + 1, size=cfg["requests"])
    offs = rng.integers(0, cfg["slab"] - cfg["max_rows"] + 1, size=cfg["requests"])
    walls, answers = [], []
    t_storm = time.perf_counter()
    for s, o in zip(sizes, offs):
        t0 = time.perf_counter()
        answers.append(h.predict(slab[o:o + s]))
        walls.append(time.perf_counter() - t0)
    storm_s = time.perf_counter() - t_storm
    pad = serving.serving_summary()["pad_rows"] - pad0
    agree = total = 0
    for (s, o), got in zip(zip(sizes, offs), answers):
        check(np.array_equal(got, model.predict(slab[o:o + s])),
              f"serve_online (a): a served answer of {s} rows differs from model.predict")
        agree += int(np.sum(got == ref[o:o + s]))
        total += int(s)
    check(progcache.stats()["misses"] == misses and batcher.xla_snapshot() == builds,
          "serve_online (a): the storm after the warmup missed the program cache or built")
    share = agree / total
    check(share >= MIN_AGREEMENT, f"serve_online (a): {share:.6f} of labels agree with float64")
    small = [slab[i * 37:i * 37 + int(n)] for i, n in enumerate(rng.integers(1, 33, cfg["many"]))]
    parts = h.predict_many(small)
    check([len(p) for p in parts] == [len(q) for q in small]
          and np.array_equal(np.concatenate(parts), model.predict(np.concatenate(small))),
          "serve_online (a): predict_many split its answers wrongly")
    walls_ms = np.sort(np.asarray(walls) * 1e3)
    return h, slab, {
        "warmup_buckets": buckets, "warmup_s": warm_s, "requests": int(cfg["requests"]),
        "rows": total, "p50_ms": float(walls_ms[len(walls_ms) // 2]),
        "p99_ms": float(walls_ms[min(len(walls_ms) - 1, int(len(walls_ms) * 0.99))]),
        "qps": cfg["requests"] / storm_s, "rows_per_s": total / storm_s, "pad_rows": pad,
        "f64_agreement": share, "predict_many_requests": len(small),
    }


def serve_ipca(cfg, dev):
    """(b) IncrementalPCA on the headline PCA table in fixed chunks
    against PCA.fit; the model served; a second delta re-pins it."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.online import IncrementalPCA

    p = cfg["pca"]
    n, d, k, rows = p["n"], p["d"], p["k"], cfg["chunk_rows"]
    x = pca_data(n, d, dev, seed=d)
    host = x.cpu().numpy()
    ref = PCA(k=k, device=str(dev)).fit(x)
    del x
    ip = IncrementalPCA(k, device=str(dev))
    pca_kernel.reset_launches()
    t0 = time.perf_counter()
    for lo in range(0, n, rows):
        ip.partial_fit(host[lo:lo + rows])
    sync(dev)
    ingest_s = time.perf_counter() - t0
    launches = dict(pca_kernel.LAUNCHES)
    chunks = -(-n // rows)
    check(launches[pca_kernel.KERNEL] == (chunks if dev.type == "cuda" else 0),
          f"serve_online (b): pca_moments launched {launches}, expected {chunks}")
    t0 = time.perf_counter()
    model = ip.commit()
    commit_s = time.perf_counter() - t0
    keep = ref.explained_variance_ > 1e-5
    comp_err = sign_err(model.components_[:, keep], ref.components_[:, keep])
    ratio_err = float(np.max(np.abs(model.explained_variance_ - ref.explained_variance_)))
    check(comp_err <= PCA_FIT_TOL and ratio_err <= 1e-5,
          f"serve_online (b): IncrementalPCA vs PCA.fit components {comp_err:.3g}, "
          f"ratios {ratio_err:.3g}")
    h = serving.serve(model)
    q = host[:4096]
    before = h.transform(q)
    delta = pca_data(cfg["pca_delta_chunks"] * rows, d, dev, seed=d + 1).cpu().numpy() + 0.5
    pca_kernel.reset_launches()
    ip.partial_fit(delta)
    delta_launches = dict(pca_kernel.LAUNCHES)
    ip.commit()
    check(h.model_version == 2, f"serve_online (b): handle version {h.model_version} after a commit")
    got = h.transform(q)
    check(np.array_equal(got, model.transform(q)) and not np.array_equal(got, before),
          "serve_online (b): the re-pinned handle does not answer with the new components")
    serving.unserve(model)
    return {"n": n, "d": d, "k": k, "chunks": chunks, "launches": launches,
            "delta_launches": delta_launches, "ingest_s": ingest_s, "commit_s": commit_s,
            "components_err": comp_err, "ratio_err": ratio_err}


def _f64_topk_check(model, ids, scores, sample, k):
    """Ids of the sampled users against a float64 numpy top-k, rows with
    a near-tie (SWEEP_TIE_RTOL) excluded; scores within it everywhere."""
    y = np.asarray(model.item_factors_, np.float64)
    compared = ties = 0
    worst = 0.0
    for lo in range(0, len(sample), 512):
        rows = sample[lo:lo + 512]
        full = np.asarray(model.user_factors_[rows], np.float64) @ y.T
        part = np.argpartition(-full, k, axis=1)[:, :k + 1]
        vals = np.take_along_axis(full, part, axis=1)
        order = np.lexsort((part, -vals))  # score descending, then id
        top = np.take_along_axis(part, order, axis=1)
        best = np.take_along_axis(vals, order, axis=1)
        scale = np.maximum(np.abs(best[:, :1]), 1e-30)
        worst = max(worst, float(np.max(np.abs(scores[rows] - best[:, :k]) / scale)))
        clear = np.all(-np.diff(best, axis=1) > SWEEP_TIE_RTOL * scale, axis=1)
        ties += int(np.sum(~clear))
        compared += int(np.sum(clear))
        check(np.array_equal(ids[rows][clear], top[clear, :k]),
              "serve_online (c): sweep ids differ from the float64 top-k off a near-tie")
    check(worst <= SWEEP_TIE_RTOL, f"serve_online (c): sweep scores {worst:.3g} from float64")
    return {"compared": compared, "near_ties": ties, "score_rel_err": worst}


def _sweep_leg(model, k, dev, rng, sample):
    from oap_mllib_tpu_torch.serving import batcher, sweep

    n_users, n_items = model.user_factors_.shape[0], model.item_factors_.shape[0]
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    ids, scores = sweep.recommend_for_all_users(model, k, with_scores=True)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    ids_m, scores_m = model.recommend_for_all_users(k, with_scores=True)
    model_wall = time.perf_counter() - t0
    check(np.array_equal(ids, ids_m) and np.array_equal(scores, scores_m),
          "serve_online (c): the sweep differs from model.recommend_for_all_users")
    rows = batcher.topk_chunk_rows(n_items, model.rank)
    # the chunk's scores (4 bytes) and keys (8), the keys' int32 staging
    # (4) and mask, and the query slots: the budget the chunk width sets
    budget = rows * n_items * 20 + 8 * rows * model.rank * 4
    if peak is not None:
        check(peak <= budget, f"serve_online (c): sweep peak {peak} bytes over the chunk "
                              f"budget {budget}")
    out = {"n_users": n_users, "n_items": n_items, "rank": model.rank, "chunk_rows": rows,
           "wall_s": wall, "users_per_s": n_users / wall, "model_call_s": model_wall,
           "peak_bytes": peak, "budget_bytes": budget,
           "score_matrix_bytes": 4 * n_users * n_items}
    if sample:
        out["f64"] = _f64_topk_check(
            model, ids, scores, rng.choice(n_users, size=min(sample, n_users), replace=False), k)
    return out


def serve_sweep(cfg, als_model, dev, rng):
    """(c) the streamed sweep of the ML-25M model and of the JAX bench's
    1,000,000 x 256 table at rank 16."""
    from oap_mllib_tpu_torch import ALSModel

    ml25 = _sweep_leg(als_model, cfg["topk"], dev, rng, cfg["sweep_sample"])
    b = cfg["bench_sweep"]
    g = np.random.default_rng(5)
    bench = ALSModel(g.normal(size=(b["n_users"], b["rank"])).astype(np.float32),
                     g.normal(size=(b["n_items"], b["rank"])).astype(np.float32),
                     device=str(dev))
    return {"ml25m": ml25, "bench": _sweep_leg(bench, cfg["topk"], dev, rng, 0)}


def _foldin_delta(cfg, n_base, n_items, seed):
    """New users from ``n_base`` (``foldin_users`` of the next
    ``foldin_span`` ids: the rest grow the table untouched), each with
    ``foldin_per_user`` ratings drawn like the base's (zipf(1.3) items,
    ratings in [1, 5))."""
    g = np.random.default_rng(seed)
    ids = n_base + np.sort(g.choice(cfg["foldin_span"], size=cfg["foldin_users"],
                                    replace=False))
    users = np.repeat(ids, cfg["foldin_per_user"])
    items = (g.zipf(1.3, size=users.size) % n_items).astype(np.int64)
    ratings = (g.random(users.size) * 4 + 1).astype(np.float32)
    return users, items, ratings


def _copy_als(model, dev):
    from oap_mllib_tpu_torch import ALSModel

    return ALSModel(model.user_factors_.copy(), model.item_factors_, model.summary,
                    device=str(dev))


def _pred_norm_err(a, b, rows, dev):
    """Relative Frobenius distance of two models' scores on ``rows`` x
    every item, summed on the card in chunks."""
    num = den = 0.0
    ya = torch.as_tensor(a.item_factors_, device=dev)
    yb = torch.as_tensor(b.item_factors_, device=dev)
    for lo in range(0, len(rows), 1024):
        r = rows[lo:lo + 1024]
        pa = torch.as_tensor(a.user_factors_[r], device=dev) @ ya.T
        pb = torch.as_tensor(b.user_factors_[r], device=dev) @ yb.T
        num += float(torch.sum((pa - pb).double() ** 2))
        den += float(torch.sum(pb.double() ** 2))
    return (num / den) ** 0.5


def serve_foldin(cfg, als_cfg, data, als_model, dev):
    """(d) 10,000 new users folded into a copy of the ML-25M model: one
    K3 and one K4 launch, bit-equal to the COO half-update of the same
    edges, the grown tail at the init, near a refit on base plus delta;
    a second delta in the same buckets misses nothing; batched by 2048,
    five launches of each and the same rows."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.utils import progcache

    users, items, ratings = data
    n_base, n_items = als_model.user_factors_.shape[0], als_model.item_factors_.shape[0]
    du, di, dr = _foldin_delta(cfg, n_base, n_items, seed=11)
    model = _copy_als(als_model, dev)
    h = serving.serve(model)
    als_kernel.reset_launches()
    t0 = time.perf_counter()
    out = model.fold_in_users(du, di, dr)
    fold_s = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    want = 1 if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: want, als_kernel.GRAM: want},
          f"serve_online (d): fold-in launches {launches}, expected one of each")
    n_new = int(du.max()) + 1
    check(out["grown"] == [n_base, n_new] and out["rows_solved"] == cfg["foldin_users"]
          and h.model_version == 2, f"serve_online (d): fold-in record {out}")
    uniq, inv = np.unique(du, return_inverse=True)
    p = model.summary["params"]
    frozen = torch.as_tensor(model.item_factors_, device=dev)
    side = als_ops.prepare_coo(inv, di, dr, np.ones(len(du), np.float32), len(uniq),
                               frozen.shape[1], dev)
    a, b, n_reg = side.partials(frozen, p["alpha"], p["implicit"])
    coo = als_ops.regularized_solve(a, b, n_reg, p["reg"],
                                    als_ops._factor_gram(frozen) if p["implicit"] else None)
    check(np.array_equal(model.user_factors_[uniq], coo.cpu().numpy()),
          "serve_online (d): folded rows differ from the COO half-update of the same edges")
    untouched = np.setdiff1d(np.arange(n_base, n_new), uniq)
    check(np.array_equal(model.user_factors_[untouched],
                         als_np.init_factors_rows(n_base, n_new, model.rank, p["seed"])[
                             untouched - n_base]),
          "serve_online (d): the grown tail's untouched rows are not at the init")
    t0 = time.perf_counter()
    refit = ALS(rank=als_model.rank, max_iter=als_cfg["max_iter"], reg_param=p["reg"],
                implicit_prefs=p["implicit"], alpha=p["alpha"], seed=p["seed"],
                device=str(dev)).fit(np.concatenate([users, du]), np.concatenate([items, di]),
                                     np.concatenate([ratings, dr]), n_new, n_items)
    refit_s = time.perf_counter() - t0
    refit_err = _pred_norm_err(model, refit, uniq, dev)
    check(refit_err < FOLDIN_REFIT_RTOL,
          f"serve_online (d): fold-in vs refit {refit_err:.3g} in prediction space")
    cause = _foldin_cause(als_cfg, p, (users, items, ratings), (du, di, dr), uniq, n_base,
                          n_new, n_items, model.summary, refit, dev)
    # a second delta in the same buckets
    du2, di2, dr2 = _foldin_delta(cfg, n_new, n_items, seed=12)
    misses = progcache.stats()["misses"]
    t0 = time.perf_counter()
    model.fold_in_users(du2, di2, dr2)
    fold2_s = time.perf_counter() - t0
    check(progcache.stats()["misses"] == misses,
          "serve_online (d): a second delta in the same buckets missed the program cache")
    # batched by online_foldin_batch rows
    batched = _copy_als(als_model, dev)
    set_config(online_foldin_batch=cfg["foldin_batch"])
    als_kernel.reset_launches()
    try:
        batched.fold_in_users(du, di, dr)
    finally:
        set_config(online_foldin_batch=0)
    batches = -(-cfg["foldin_users"] // cfg["foldin_batch"])
    blaunch = dict(als_kernel.LAUNCHES)
    want = batches if dev.type == "cuda" else 0
    check(blaunch == {als_kernel.SOLVE: want, als_kernel.GRAM: want},
          f"serve_online (d): batched fold-in launches {blaunch}, expected {want} of each")
    check(np.array_equal(batched.user_factors_[uniq], coo.cpu().numpy()),
          "serve_online (d): the batched fold-in's rows differ from the one-launch rows")
    serving.unserve(model)
    return {"users": cfg["foldin_users"], "edges": int(len(du)), "grown": out["grown"],
            "launches": launches, "batched_launches": blaunch, "batches": batches,
            "foldin_s": fold_s, "second_delta_s": fold2_s, "refit_s": refit_s,
            "refit_pred_rel_err": refit_err, "refit_distance_by_items": cause,
            "untouched_grown_rows": int(len(untouched))}, du, di, dr


def _foldin_cause(als_cfg, p, base, delta, uniq, n_base, n_new, n_items, summary, refit, dev):
    """Where the fold-in's distance from the refit comes from: the same
    delta folded against the refit's own item tables.  Against the
    table its last user half-update solved with (the ninth iteration's:
    a refit one iteration shorter, from the same seed) the folded rows
    should be the refit's rows up to the layouts' rounding (COO here,
    grouped there); against its final table, one iteration's drift."""
    from oap_mllib_tpu_torch import ALSModel

    fit_args = [np.concatenate([a, b]) for a, b in zip(base, delta)] + [n_new, n_items]
    short = ALS(rank=refit.rank, max_iter=als_cfg["max_iter"] - 1, reg_param=p["reg"],
                implicit_prefs=p["implicit"], alpha=p["alpha"], seed=p["seed"],
                device=str(dev)).fit(*fit_args)
    want = refit.user_factors_[uniq].astype(np.float64)
    out = {}
    for tag, items_tbl in (("refit_iter_minus_1_items", short.item_factors_),
                           ("refit_final_items", refit.item_factors_)):
        folded = ALSModel(refit.user_factors_[:n_base].copy(), items_tbl, summary,
                          device=str(dev))
        folded.fold_in_users(*delta)
        rows = folded.user_factors_[uniq].astype(np.float64)
        out[tag] = {
            "rows_rel_err": float(np.linalg.norm(rows - want) / np.linalg.norm(want)),
            "pred_rel_err": _pred_norm_err(folded, refit, uniq, dev)}
    return out


def serve_partial_fit(cfg, model, h, dev):
    """(e) a 2^18-row delta from the same blobs through partial_fit in
    65,536-row chunks: K1 once a chunk, the centers against the plain K1's
    fold on the CPU, the counts exact; the served handle re-pinned."""
    from oap_mllib_tpu_torch.data.stream import ChunkSource
    from oap_mllib_tpu_torch.online import minibatch

    kc = cfg["kmeans"]
    xd = blob_delta(cfg["delta_rows"], kc["d"], kc["k"], dev, seed=0, draw_seed=101)
    host = xd.cpu().numpy()
    del xd
    rows = cfg["chunk_rows"]
    centers0 = model.cluster_centers_.copy()
    seed = minibatch._seed_counts(model, kc["k"])
    version = h.model_version
    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    model.partial_fit(ChunkSource.from_array(host, chunk_rows=rows))
    fit_s = time.perf_counter() - t0
    launches = dict(kmeans_kernel.LAUNCHES)
    chunks = -(-len(host) // rows)
    check(launches[kmeans_kernel.KERNEL] == (chunks if dev.type == "cuda" else 0),
          f"serve_online (e): kmeans_accumulate launched {launches}, expected {chunks}")
    # the plain K1 on the CPU over the same chunks, folded the same way
    c = torch.from_numpy(centers0.astype(np.float32))
    sums = torch.zeros_like(c)
    counts = torch.zeros(c.shape[0])
    for lo in range(0, len(host), rows):
        xc = torch.from_numpy(host[lo:lo + rows])
        s, n, _ = kmeans_kernel.lloyd_accumulate_plain(xc, torch.ones(len(xc)), c, "highest",
                                                       False)
        sums += s
        counts += n
    denom = seed + counts.double().numpy()
    want = np.where(denom[:, None] > 0,
                    (centers0.astype(np.float64) * seed[:, None] + sums.double().numpy())
                    / np.maximum(denom[:, None], 1e-300), centers0).astype(np.float32)
    err = _rel_err(torch.from_numpy(model.cluster_centers_), torch.from_numpy(want))
    check(err <= PARTIAL_FIT_RTOL, f"serve_online (e): partial_fit centers {err:.3g} from "
                                   "the plain K1's fold")
    check(np.array_equal(model._online_counts, denom),
          "serve_online (e): partial_fit counts differ from the plain K1's")
    check(h.model_version == version + 1,
          f"serve_online (e): handle version {h.model_version}, expected {version + 1}")
    q = host[:4096]
    check(np.array_equal(h.predict(q), model.predict(q)),
          "serve_online (e): the re-pinned handle differs from model.predict")
    return {"rows": len(host), "chunks": chunks, "launches": launches, "partial_fit_s": fit_s,
            "centers_rel_err": err, "moved_rows": int(counts.sum())}, host


def serve_faults(cfg, km_model, hk, km_delta, als_model, foldin_delta, dev):
    """(f) a failed delta leaves the model's arrays, the served answers
    and the handle's version as they were: ``delta.ingest`` on (e),
    ``delta.solve:err=2`` on (d) with batches of ``foldin_batch`` rows."""
    from oap_mllib_tpu_torch import serving

    q = km_delta[:4096]
    centers, version, answer = km_model.cluster_centers_, hk.model_version, hk.predict(q)
    _armed_fault("delta.ingest:err=1")
    try:
        km_model.partial_fit(km_delta)
        raise Failed("serve_online (f): delta.ingest armed, partial_fit did not raise")
    except faults.FaultInjected:
        pass
    finally:
        _armed_fault("")
    check(km_model.cluster_centers_ is centers and hk.model_version == version
          and np.array_equal(hk.predict(q), answer),
          "serve_online (f): a failed partial_fit moved the model or its handle")
    model = _copy_als(als_model, dev)
    h = serving.serve(model)
    users = np.arange(64)
    table, answer = model.user_factors_, h.recommend_for_users(users, 10, with_scores=True)
    set_config(online_foldin_batch=cfg["foldin_batch"])
    _armed_fault("delta.solve:err=2")
    als_kernel.reset_launches()
    try:
        model.fold_in_users(*foldin_delta)
        raise Failed("serve_online (f): delta.solve armed, fold_in_users did not raise")
    except faults.FaultInjected:
        pass
    finally:
        _armed_fault("")
        set_config(online_foldin_batch=0)
    launches = dict(als_kernel.LAUNCHES)
    # the grammar's count fires the first N calls: ``err=2`` stops the
    # first batch before its launches.  Mid-commit: the second batch's
    # solve raises after the first batch's K3 and K4 ran
    real, calls = als_ops.regularized_solve, []

    def second_fails(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("planted: the second batch's solve failed")
        return real(*a, **kw)

    set_config(online_foldin_batch=cfg["foldin_batch"])
    als_ops.regularized_solve = second_fails
    als_kernel.reset_launches()
    try:
        model.fold_in_users(*foldin_delta)
        raise Failed("serve_online (f): the planted mid-commit failure did not raise")
    except RuntimeError as e:
        check("planted" in str(e), f"serve_online (f): mid-commit leg raised {e!r}")
    finally:
        als_ops.regularized_solve = real
        set_config(online_foldin_batch=0)
    mid = dict(als_kernel.LAUNCHES)
    want = 1 if dev.type == "cuda" else 0
    check(mid[als_kernel.SOLVE] == want,
          f"serve_online (f): {mid} launched before the mid-commit failure")
    again = h.recommend_for_users(users, 10, with_scores=True)
    check(model.user_factors_ is table and h.model_version == 1
          and all(np.array_equal(u, v) for u, v in zip(again, answer)),
          "serve_online (f): a failed fold-in moved the model or its handle")
    serving.unserve(model)
    return {"foldin_launches_before_fault": launches, "mid_commit_launches": mid}


def blob_delta(n, d, k, dev, seed, draw_seed, spread=2.0):
    """``n`` new rows of the blobs that :func:`blobs` makes from ``seed``
    (its blob centers), drawn from ``draw_seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    true = torch.randn((k, d), generator=g, device=dev) * spread
    g2 = torch.Generator(device=dev)
    g2.manual_seed(draw_seed)
    lab = torch.randint(0, k, (n,), generator=g2, device=dev)
    return (true[lab] + torch.randn((n, d), generator=g2, device=dev)).contiguous()


def phase_serve_online(cfg, als_cfg, dev, slab=None, km_model=None, data=None,
                       als_model=None):
    """Phase 28: the serving core and the online updates (module
    docstring).  ``slab`` is the host copy of the blobs' first
    ``cfg["slab"]`` rows that ``km_model`` was fitted on.  Without a
    fitted headline K-Means or ML-25M ALS (the ``--online`` run) the
    phase fits them first."""
    from oap_mllib_tpu_torch import serving

    rng = np.random.default_rng(28)
    kc = cfg["kmeans"]
    if "als" in cfg:
        als_cfg, data, als_model = cfg["als"], None, None
    if km_model is None:
        x, _, _ = blobs(kc["n"], kc["d"], kc["k"], dev, seed=0)
        km_model = KMeans(k=kc["k"], max_iter=kc["max_iter"], tol=1e-4,
                          init_mode="k-means||", seed=0, device=str(dev)).fit(x)
        slab = x[: cfg["slab"]].cpu().numpy()
        del x
    if data is None:
        data = als_data(als_cfg)
    if als_model is None:
        als_model = ALS(rank=als_cfg["rank"], max_iter=als_cfg["max_iter"],
                        reg_param=als_cfg["reg"], implicit_prefs=True, alpha=als_cfg["alpha"],
                        seed=0, device=str(dev)).fit(*data, als_cfg["n_users"],
                                                     als_cfg["n_items"])
    t_phase = time.perf_counter()
    hk, _, storm = serve_kmeans_storm(cfg, slab, km_model, dev, rng)
    emit("serve_online_a", storm)
    ipca = serve_ipca(cfg, dev)
    emit("serve_online_b", ipca)
    sweep_res = serve_sweep(cfg, als_model, dev, rng)
    emit("serve_online_c", sweep_res)
    foldin, *fdelta = serve_foldin(cfg, als_cfg, data, als_model, dev)
    emit("serve_online_d", foldin)
    partial, km_delta = serve_partial_fit(cfg, km_model, hk, dev)
    emit("serve_online_e", partial)
    fault = serve_faults(cfg, km_model, hk, km_delta, als_model, fdelta, dev)
    emit("serve_online_f", fault)
    summary = serving.serving_summary()
    serving.registry.clear()
    out = {"a": storm, "b": ipca, "c": sweep_res, "d": foldin, "e": partial, "f": fault,
           "serving_summary": summary, "wall_s": time.perf_counter() - t_phase}
    emit("serve_online", {"wall_s": out["wall_s"], "serving_summary": summary})
    return out


# -- phase 29: the serving front -----------------------------------------------------

TRAFFIC_FULL = {"kmeans": {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20},
                "slab": 1 << 16, "max_rows": 4096, "requests": 2000, "threads": 4,
                "window": 16, "deadline_ms": 50.0, "burst": 20, "depth": 8,
                "bf16_requests": 200, "stale_requests": 1500,
                "delta_rows": 1 << 18, "chunk_rows": 1 << 16, "faulted_requests": 300,
                "drain_requests": 12, "slo_p99_ms": 50.0, "ha_requests": 40,
                "ha_rows": 1024, "ha_burst": 64, "ha_high": 8.0}
TRAFFIC_TINY = {"kmeans": {"n": 4133, "d": 29, "k": 11, "max_iter": 5},
                "slab": 2048, "max_rows": 256, "requests": 120, "threads": 4,
                "window": 4, "deadline_ms": 50.0, "burst": 20, "depth": 8,
                "bf16_requests": 30, "stale_requests": 60,
                "delta_rows": 2048, "chunk_rows": 512, "faulted_requests": 40,
                "drain_requests": 6, "slo_p99_ms": 50.0, "ha_requests": 8,
                "ha_rows": 64, "ha_burst": 16, "ha_high": 2.0}
# the JAX package's payload keys (its telemetry/fleet.py and serving/):
# /sloz armed, /healthz, and /healthz's serving block with a model
# pinned, a shed behind it and the SLO engine armed
SLOZ_KEYS = {"armed", "p99_ms", "availability", "window_s", "fast_window_s", "requests",
             "bad", "lifetime_requests", "lifetime_bad", "burn_rate_fast",
             "burn_rate_slow", "error_budget_remaining", "breach"}
HEALTHZ_KEYS = {"ok", "rank", "world", "fit", "phase", "step", "ladder", "last_collective",
                "flight_recorder_seq", "fleet_passes", "capability", "rows_processed",
                "serving"}
HEALTHZ_SERVING_KEYS = {"queue_depth", "in_flight", "pinned_models", "models",
                        "brownout_rung", "last_shed", "slo"}
HA_TIMEOUT_S = 300


def _zero_launches():
    for mod in (kmeans_kernel, pca_kernel, als_kernel, ring_kernel):
        mod.reset_launches()


def _launches():
    return {**kmeans_kernel.LAUNCHES, **pca_kernel.LAUNCHES, **als_kernel.LAUNCHES,
            **ring_kernel.LAUNCHES}


class GroupSpy:
    """A serving handle whose ``predict_many`` records each flush's
    requests, by the submitted arrays' identity (``index``)."""

    def __init__(self, handle, index):
        self.h, self.index = handle, index
        self.kind, self.device = handle.kind, handle.device
        self.groups = []
        self._lock = threading.Lock()

    def predict_many(self, batches):
        out = self.h.predict_many(batches)
        with self._lock:
            self.groups.append([self.index[id(b)] for b in batches])
        return out


def traffic_storm(q, reqs, threads, window, deadline_ms, first_done=None):
    """``reqs`` through ``q`` from ``threads`` closed-loop clients, each
    keeping at most ``window`` requests in flight.  Returns each request's
    future (None when shed at submit), submit and resolution times,
    resolution counts, the sheds at submit by reason, and the wall.
    ``first_done`` (a threading.Event) is set once a request resolves,
    after its resolution time is taken."""
    from oap_mllib_tpu_torch.serving import ShedError

    n = len(reqs)
    futs, t_sub, t_done, resolved = [None] * n, [0.0] * n, [0.0] * n, [0] * n
    sheds, errors = {}, []
    lock = threading.Lock()

    def done_at(i):
        def cb(_f):
            t = time.perf_counter()
            with lock:
                t_done[i] = t
                resolved[i] += 1
            if first_done is not None:
                first_done.set()
        return cb

    def client(c):
        try:
            inflight = []
            for i in range(c, n, threads):
                while len(inflight) >= window:
                    inflight.pop(0).exception(timeout=120)
                t_sub[i] = time.perf_counter()
                try:
                    f = q.submit(reqs[i], deadline_ms=deadline_ms)
                except ShedError as e:
                    with lock:
                        sheds[e.reason] = sheds.get(e.reason, 0) + 1
                    continue
                futs[i] = f
                f.add_done_callback(done_at(i))
                inflight.append(f)
            for f in inflight:
                f.exception(timeout=120)
        except Exception as e:  # noqa: BLE001 -- reported after the join
            errors.append(repr(e))

    workers = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(300)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in workers),
          f"serve_traffic: a storm client failed: {errors[:3]}")
    return {"futs": futs, "t_sub": t_sub, "t_done": t_done, "resolved": resolved,
            "sheds": sheds, "wall_s": wall}


def storm_report(tag, st, reqs, offs, ref, spy, h):
    """Check one storm's futures and answers; returns its figures.  Every
    future resolves exactly once; every answer agrees with the float64
    labels ``ref`` (>= MIN_AGREEMENT of the rows) and is bit-equal to
    ``h.predict_many`` of its own flush group."""
    from oap_mllib_tpu_torch.serving import ServeError, ShedError

    answered, walls, sheds, failed = {}, [], dict(st["sheds"]), {}
    for i, f in enumerate(st["futs"]):
        if f is None:
            continue
        check(f.done() and st["resolved"][i] == 1,
              f"serve_traffic {tag}: request {i} resolved {st['resolved'][i]} times")
        exc = f.exception()
        if exc is None:
            answered[i] = f.result()
            walls.append(st["t_done"][i] - st["t_sub"][i])
        elif isinstance(exc, ShedError):
            sheds[exc.reason] = sheds.get(exc.reason, 0) + 1
        elif isinstance(exc, ServeError):
            failed[exc.reason] = failed.get(exc.reason, 0) + 1
        else:
            raise Failed(f"serve_traffic {tag}: request {i} raised {exc!r}")
    agree = rows = 0
    for i, got in answered.items():
        o = offs[i]
        agree += int(np.sum(got == ref[o:o + len(got)]))
        rows += len(got)
    share = agree / max(rows, 1)
    check(share >= MIN_AGREEMENT,
          f"serve_traffic {tag}: {share:.6f} of labels agree with float64")
    grouped = 0
    for g in spy.groups:
        parts = h.predict_many([reqs[j] for j in g])
        for j, part in zip(g, parts):
            if j in answered:
                check(np.array_equal(part, answered[j]),
                      f"serve_traffic {tag}: request {j} differs from predict_many of its "
                      "flush group")
                grouped += 1
    check(grouped == len(answered),
          f"serve_traffic {tag}: {grouped} of {len(answered)} answers found in a flush group")
    walls_ms = np.sort(np.asarray(walls) * 1e3) if walls else np.zeros(1)
    flush_rows = [sum(len(reqs[j]) for j in g) for g in spy.groups]
    return answered, {
        "requests": len(reqs), "answered": len(answered), "sheds": sheds, "failed": failed,
        "p50_ms": float(walls_ms[len(walls_ms) // 2]),
        "p99_ms": float(walls_ms[min(len(walls_ms) - 1, int(len(walls_ms) * 0.99))]),
        "requests_per_s": len(answered) / st["wall_s"], "wall_s": st["wall_s"],
        "rows_per_s": rows / st["wall_s"], "flushes": len(spy.groups),
        "rows_per_flush": float(np.mean(flush_rows)) if flush_rows else 0.0,
        "requests_per_flush": len(answered) / max(len(spy.groups), 1),
        "f64_agreement": share,
    }


def _requests(cfg, rng, slab, n):
    sizes = rng.integers(1, cfg["max_rows"] + 1, size=n)
    offs = rng.integers(0, len(slab) - cfg["max_rows"] + 1, size=n)
    return [slab[o:o + s] for s, o in zip(sizes, offs)], offs


def run_storm(tag, cfg, h, reqs, offs, ref, deadline_ms, **q_kw):
    """One storm through a fresh TrafficQueue; the program cache and the
    kernel launches are read around it."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.serving import batcher
    from oap_mllib_tpu_torch.utils import progcache

    spy = GroupSpy(h, {id(r): i for i, r in enumerate(reqs)})
    misses, builds = progcache.stats()["misses"], batcher.xla_snapshot()
    _zero_launches()
    with serving.TrafficQueue(spy, max_batch_rows=cfg["max_rows"], **q_kw) as q:
        st = traffic_storm(q, reqs, cfg["threads"], cfg["window"], deadline_ms)
    launches = _launches()
    cache = {"misses": progcache.stats()["misses"] - misses,
             "builds": batcher.xla_snapshot() - builds}
    answered, rep = storm_report(tag, st, reqs, offs, ref, spy, h)
    rep.update(launches=launches, after_warmup=cache)
    return answered, rep, st


def traffic_a(cfg, h, slab, ref, rng):
    """(a) the storm with no deadline and with 50 ms; no cache miss."""
    reqs, offs = _requests(cfg, rng, slab, cfg["requests"])
    out = {}
    for tag, dl in (("no_deadline", 0.0), ("deadline", cfg["deadline_ms"])):
        _, rep, _ = run_storm(f"(a) {tag}", cfg, h, reqs, offs, ref, dl)
        check(rep["after_warmup"] == {"misses": 0, "builds": 0},
              f"serve_traffic (a) {tag}: {rep['after_warmup']} after the warmup")
        check(not any(rep["launches"].values()), f"serve_traffic (a): launched {rep['launches']}")
        if tag == "no_deadline":
            check(rep["answered"] == len(reqs), "serve_traffic (a): a request went unanswered")
        out[tag] = rep
    return out, (reqs, offs)


def traffic_b(cfg, h, ref, storm, sink, port):
    """(b) the same storm traced at serve_trace_sample=1 with the SLO
    engine armed: ledgers sum to their walls, one sink record a sampled
    request, exemplars on /metrics; then the storm untraced again."""
    from oap_mllib_tpu_torch.serving import reqtrace
    from oap_mllib_tpu_torch.telemetry import fleet as tfleet

    reqs, offs = storm
    set_config(serve_trace_sample=1.0, telemetry_log=sink, serve_slo_p99_ms=cfg["slo_p99_ms"],
               metrics_port=port)
    check(tfleet.maybe_serve() == port, "serve_traffic (b): the metrics endpoint did not start")
    answered, rep, st = run_storm("(b) traced", cfg, h, reqs, offs, ref, 0.0)
    ledgers = [reqtrace.ledger_of(f) for f in st["futs"] if f is not None]
    worst = max(abs(lg.stage_sum() - lg.wall_s) for lg in ledgers)
    check(worst <= 1e-6, f"serve_traffic (b): a ledger's stages miss its wall by {worst:.3g} s")
    sampled = sum(lg.ctx.sampled for lg in ledgers)
    with open(sink) as f:
        records = [json.loads(ln) for ln in f if '"request"' in ln]
    records = [r for r in records if r.get("type") == "request"]
    check(len(records) == sampled == len(ledgers),
          f"serve_traffic (b): {len(records)} sink records, {sampled} sampled requests")
    text = _http(port, "/metrics")
    exemplars = [ln for ln in text.splitlines()
                 if ln.startswith("oap_serve_request_seconds_bucket") and "trace_id=" in ln]
    check(bool(exemplars), "serve_traffic (b): no exemplar on /metrics")
    stages = {s: float(np.percentile([lg.stages[s] for lg in ledgers], 99)) * 1e3
              for s in reqtrace.STAGES}
    set_config(serve_trace_sample=0.0, telemetry_log="")
    _, off_again, _ = run_storm("(b) off again", cfg, h, reqs, offs, ref, 0.0)
    return {"traced": rep, "off_again": off_again, "ledgers": len(ledgers),
            "worst_sum_err_s": worst, "sink_records": len(records),
            "exemplar_lines": len(exemplars), "stage_p99_ms": stages,
            "stage_hist_p99_ms": {s: v["p99_s"] * 1e3
                                  for s, v in reqtrace.stage_quantiles().items()},
            "attribution_coverage": reqtrace.attribution_block()["coverage"]}


def traffic_c(cfg, h, model, slab, ref, rng):
    """(c) a burst at serve_queue_depth=8 sheds queue_full; a small
    serve_shed_headroom steps the ladder topk -> bf16 -> stale, then the
    budget shed resumes; at the bf16 rung answers equal the model's own
    call under serving_precision="bf16"."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.serving import traffic
    from oap_mllib_tpu_torch.telemetry import metrics as tm

    out = {}
    _zero_launches()
    set_config(serve_queue_depth=cfg["depth"])
    q = serving.TrafficQueue(h, start=False)
    futs, sheds = [], {}
    for i in range(cfg["burst"]):
        try:
            futs.append((i, q.submit(slab[i * 16:i * 16 + 16])))
        except serving.ShedError as e:
            sheds[e.reason] = sheds.get(e.reason, 0) + 1
    q.pump()
    q.close()
    check(sheds == {"queue_full": cfg["burst"] - cfg["depth"]} and len(futs) == cfg["depth"],
          f"serve_traffic (c): the burst shed {sheds}")
    # one pump, one flush: bit-equal to predict_many of the admitted
    got = np.concatenate([f.result() for _, f in futs])
    want = np.concatenate(h.predict_many([slab[i * 16:i * 16 + 16] for i, _ in futs]))
    check(np.array_equal(got, want), "serve_traffic (c): the burst's answers differ from "
                                     "predict_many of its flush")
    rows = slice(0, 16 * cfg["depth"])
    out["burst"] = {"admitted": len(futs), "sheds": sheds,
                    "f64_agreement": float(np.mean(got == ref[rows]))}
    set_config(serve_queue_depth=256)
    # the ladder: an allowance of half a full request, so every
    # admission prices over it; the first window of breaches sheds, then
    # each full window steps a rung and the breaches are absorbed, until
    # the top rung, where the budget shed resumes
    hbm = membudget.Budgets.resolve().hbm
    req = slab[:cfg["max_rows"]]
    headroom = 0.5 * req.nbytes / hbm
    set_config(serve_shed_headroom=headroom, serve_brownout="off")
    traffic.brownout()
    set_config(serve_brownout="auto")
    b = traffic.brownout()
    steps0 = tm.family_total("oap_serve_brownout_steps_total")
    q = serving.TrafficQueue(h, start=False)
    trail = []
    for _ in range(4 * b.WINDOW):
        try:
            q.submit(req)
            trail.append((b.rung, None))
        except serving.ShedError as e:
            trail.append((b.rung, e.reason))
            if b.rung == 3:
                break
    q.close()
    check([s["to"] for s in b.steps] == ["topk", "bf16", "stale"]
          and trail[-1] == (3, "budget") and all(r in (None, "budget") for _, r in trail),
          f"serve_traffic (c): the ladder went {b.steps}, {trail}")
    check(tm.family_total("oap_serve_brownout_steps_total") - steps0 == 3,
          "serve_traffic (c): the ladder's steps were not booked")
    out["ladder"] = {"hbm_bytes": hbm, "headroom": headroom, "trail": trail,
                     "steps": b.steps, "absorbed": b.absorbed,
                     "summary_brownout": serving.serving_summary()["brownout"]}
    set_config(serve_shed_headroom=0.5, serve_brownout="pin:bf16")
    # the bf16 rung is its own program family: warm it first
    h.warmup(cfg["max_rows"])
    reqs, offs = _requests(cfg, rng, slab, cfg["bf16_requests"])
    spy = GroupSpy(h, {id(r): i for i, r in enumerate(reqs)})
    with serving.TrafficQueue(spy, max_batch_rows=cfg["max_rows"]) as q:
        st = traffic_storm(q, reqs, cfg["threads"], cfg["window"], 0.0)
    set_config(serve_brownout="off", serving_precision="bf16")
    agree_f64 = agree_f32 = rows = 0
    f32 = None
    for g in spy.groups:
        joined = np.concatenate([reqs[j] for j in g])
        want = model.predict(joined)
        got = np.concatenate([st["futs"][j].result() for j in g])
        check(np.array_equal(got, want), "serve_traffic (c): a bf16-rung answer differs from "
                                         "the model's call under serving_precision=bf16")
    set_config(serving_precision="")
    f32 = model.predict(slab)
    for i, f in enumerate(st["futs"]):
        got, o = f.result(), offs[i]
        agree_f64 += int(np.sum(got == ref[o:o + len(got)]))
        agree_f32 += int(np.sum(got == f32[o:o + len(got)]))
        rows += len(got)
    out["bf16"] = {"requests": len(reqs), "flushes": len(spy.groups), "rows": rows,
                   "f32_agreement": agree_f32 / rows, "f64_agreement": agree_f64 / rows}
    out["launches"] = _launches()
    check(not any(out["launches"].values()), f"serve_traffic (c): launched {out['launches']}")
    return out


def traffic_d(cfg, h, model, slab, rng, dev):
    """(d) under serve_brownout="pin:stale" (scoring pinned to f32) a storm
    runs while partial_fit of ``delta_rows`` headline rows commits: K1 once
    a chunk, no failed future, every answer the float64 argmin under the
    old or the new centers, the handle's version up by one."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.data.stream import ChunkSource

    kc = cfg["kmeans"]
    set_config(serve_brownout="pin:stale", serving_precision="f32")
    old = _f64_labels(slab, model.cluster_centers_)
    delta = blob_delta(cfg["delta_rows"], kc["d"], kc["k"], dev, seed=0,
                       draw_seed=129).cpu().numpy()
    reqs, offs = _requests(cfg, rng, slab, cfg["stale_requests"])
    version = h.model_version
    box, first = {}, threading.Event()
    with serving.TrafficQueue(h, max_batch_rows=cfg["max_rows"]) as q:
        storm = threading.Thread(target=lambda: box.update(
            st=traffic_storm(q, reqs, cfg["threads"], cfg["window"], 0.0, first)),
            daemon=True)
        storm.start()
        # the commit starts once the storm is answering: a fixed 20 ms
        # alone left a slow host's storm with no answer before it
        time.sleep(0.02)
        first.wait(60)
        _zero_launches()
        t0 = time.perf_counter()
        model.partial_fit(ChunkSource.from_array(delta, chunk_rows=cfg["chunk_rows"]))
        t_commit = time.perf_counter()
        launches = _launches()
        storm.join(300)
    check("st" in box, "serve_traffic (d): the storm did not finish")
    st = box["st"]
    new = _f64_labels(slab, model.cluster_centers_)
    chunks = -(-len(delta) // cfg["chunk_rows"])
    check(launches[kmeans_kernel.KERNEL] == (chunks if dev.type == "cuda" else 0),
          f"serve_traffic (d): partial_fit launched {launches}, expected {chunks} K1")
    check(h.model_version == version + 1,
          f"serve_traffic (d): version {h.model_version}, expected {version + 1}")
    agree = rows = after = 0
    for i, f in enumerate(st["futs"]):
        check(f is not None and f.exception() is None, f"serve_traffic (d): request {i} failed")
        got, o = f.result(), offs[i]
        agree += int(np.sum((got == old[o:o + len(got)]) | (got == new[o:o + len(got)])))
        rows += len(got)
        after += st["t_done"][i] > t_commit
    share = agree / rows
    check(share >= MIN_AGREEMENT, f"serve_traffic (d): {share:.6f} of labels are neither "
                                  "float64 argmin")
    before = sum(st["t_done"][i] < t0 for i in range(len(reqs)))
    check(dev.type != "cuda" or (before > 0 and after > 0),
          f"serve_traffic (d): the storm did not span the commit ({before} answered before "
          f"partial_fit, {after} after it)")
    set_config(serve_brownout="auto", serving_precision="")
    return {"launches": launches, "chunks": chunks, "partial_fit_s": t_commit - t0,
            "requests": len(reqs), "answered_before_fit": before,
            "answered_after_commit": after,
            "version": [version, h.model_version], "old_or_new_agreement": share,
            "labels_moved": int(np.sum(old != new)), "storm_wall_s": st["wall_s"]}


def traffic_e(cfg, h, slab, ref, rng):
    """(e) bench.py's degraded storm: the stale rung (bf16 scoring),
    serve.dispatch:fail=2 and two NaN requests: exactly those two
    quarantined, retries booked, the rest answered; then a drain with
    pending work posts its report and the supervisor reads it back."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.telemetry import metrics as tm
    from oap_mllib_tpu_torch.utils.supervisor import Supervisor

    set_config(serve_brownout="pin:stale")
    h.warmup(cfg["max_rows"])
    reqs, offs = _requests(cfg, rng, slab, cfg["faulted_requests"])
    nan_at = {3, len(reqs) // 2}
    for i in nan_at:
        reqs[i] = reqs[i].copy()
        reqs[i][0, 0] = np.nan
    poison0 = tm.family_total("oap_serve_poison_total")
    retries0 = tm.family_total("oap_serve_retries_total")
    _armed_fault("serve.dispatch:fail=2")
    _zero_launches()
    try:
        with serving.TrafficQueue(h, max_batch_rows=cfg["max_rows"]) as q:
            st = traffic_storm(q, reqs, cfg["threads"], cfg["window"], 120_000.0)
    finally:
        _armed_fault("")
    launches = _launches()
    poisoned, agree, rows = [], 0, 0
    for i, f in enumerate(st["futs"]):
        exc = f.exception()
        if exc is not None:
            check(isinstance(exc, serving.ServeError) and exc.reason == "poison",
                  f"serve_traffic (e): request {i} raised {exc!r}")
            poisoned.append(i)
            continue
        got, o = f.result(), offs[i]
        agree += int(np.sum(got == ref[o:o + len(got)]))
        rows += len(got)
    retries = tm.family_total("oap_serve_retries_total") - retries0
    check(sorted(poisoned) == sorted(nan_at)
          and tm.family_total("oap_serve_poison_total") - poison0 == 2,
          f"serve_traffic (e): quarantined {poisoned}, expected {sorted(nan_at)}")
    check(retries > 0, "serve_traffic (e): the dispatch faults booked no retry")
    side = _scratch("serve_traffic_sideband")
    set_config(crash_dir=side, serve_brownout="auto")
    q = serving.TrafficQueue(h, start=False)
    for i in range(cfg["drain_requests"]):
        q.submit(slab[i * 8:i * 8 + 8])
    stats = q.drain(timeout_s=30.0)
    q.close()
    reports = Supervisor(lambda *a: [], 1, side)._read_drain_reports()
    set_config(crash_dir="")
    check(stats["drained"] and stats["answered"] == cfg["drain_requests"]
          and len(reports) == 1 and reports[0]["answered"] == cfg["drain_requests"],
          f"serve_traffic (e): drain {stats}, the supervisor read {reports}")
    return {"requests": len(reqs), "poisoned": sorted(poisoned), "retries": retries,
            "launches": launches, "bf16_f64_agreement": agree / rows,
            "futures": serving.serving_summary().get("futures"), "drain": stats,
            "supervisor_read": reports}


def traffic_f(port):
    """(f) GET /sloz and /healthz over localhost: the JAX payloads' keys,
    the burn rates."""
    sloz = json.loads(_http(port, "/sloz"))
    health = json.loads(_http(port, "/healthz"))
    check(set(sloz) == SLOZ_KEYS and sloz["armed"],
          f"serve_traffic (f): /sloz keys {sorted(sloz)}")
    check(set(health) == HEALTHZ_KEYS and set(health["serving"]) == HEALTHZ_SERVING_KEYS,
          f"serve_traffic (f): /healthz keys {sorted(health)}, serving "
          f"{sorted(health['serving'])}")
    return {"sloz": sloz, "healthz_serving": health["serving"]}


def ha_worker(argv) -> int:
    """One replica of leg (g): serve, heartbeat with the other, and (process
    1) die by SIGKILL; process 0 evicts it and keeps answering."""
    import signal

    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.convert import kmeans_model_from_arrays
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.telemetry import metrics as tm
    from oap_mllib_tpu_torch.utils import recovery

    rank, port, out, device = int(argv[0]), int(argv[1]), argv[2], argv[3]
    cfg = TRAFFIC_TINY if "--rehearse" in argv else TRAFFIC_FULL
    side = os.path.join(out, "sideband")
    set_config(device=device, crash_dir=side, collective_timeout=60.0,
               serve_scale_high=cfg["ha_high"])
    bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, rank, launcher_store=True)
    h = serving.serve(kmeans_model_from_arrays(np.load(os.path.join(out, "centers.npy")),
                                               device=device))
    h.warmup(cfg["ha_rows"])
    x = np.load(os.path.join(out, "requests.npy"))
    reqs = [x[i * 7:i * 7 + 1 + (i * 97) % cfg["ha_rows"]] for i in range(cfg["ha_requests"])]
    q = serving.TrafficQueue(h)
    guard = serving.ReplicaGuard(queue=q)
    # one request a flush, before and after: each scores at its own bucket
    before = [q.submit(r).result(timeout=60) for r in reqs]
    with guard.leg():
        view = serving.heartbeat()
    evictions = tm.family_total("oap_serve_evictions_total")
    _zero_launches()
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.perf_counter()
    with guard.leg():
        serving.heartbeat()
    evict_s = time.perf_counter() - t0
    after = [q.submit(r).result(timeout=60) for r in reqs]
    # the survivor alone against a backlog: the controller votes a
    # replica out and posts it for the supervisor
    burst = serving.TrafficQueue(h, start=False)
    for r in reqs[:cfg["ha_burst"]] * (1 + cfg["ha_burst"] // len(reqs)):
        if burst.depth() < cfg["ha_burst"]:
            burst.submit(r)
    sc = serving.ScaleController(1)
    decisions = [sc.observe(queue_depth=burst.depth()) for _ in range(sc.WINDOW)]
    hint = serving.write_scale_hint(side, decisions[-1])
    burst.close()
    stats = guard.release(timeout_s=30.0)
    res = {"rank": rank, "view": view, "local_only": guard.local_only,
           "evicted": serving.fleet_evicted(), "error": type(guard.last_error).__name__,
           "evictions": tm.family_total("oap_serve_evictions_total") - evictions,
           "evict_s": evict_s, "same": all(np.array_equal(a, b) for a, b in zip(before, after)),
           "answers": len(after), "decision": decisions[-1], "hint": hint,
           "drained": stats["drained"], "launches": _launches()}
    print("HA_RESULT " + json.dumps(res, default=str), flush=True)
    recovery.exit_now(0)
    return 0


def traffic_g(cfg, model, slab, dev, rehearse):
    """(g) two replicas sharing the card, a process each, each its own
    queue: heartbeats gather both; process 1 is SIGKILLed; the survivor's
    ReplicaGuard evicts it and keeps answering bit-equal; its scale
    decision lands in serve.scale.hint.json, which the supervisor reads."""
    import datetime

    import torch.distributed as dist

    from oap_mllib_tpu_torch.utils.supervisor import Supervisor

    out = _scratch("serve_traffic_ha")
    np.save(os.path.join(out, "centers.npy"), model.cluster_centers_)
    np.save(os.path.join(out, "requests.npy"), slab[:8 * cfg["ha_rows"]])
    store = dist.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=HA_TIMEOUT_S))
    flags = ["--rehearse"] if rehearse else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ha-worker", str(r),
                               str(store.port), out, str(dev), *flags],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        text = procs[0].communicate(timeout=HA_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        raise Failed(f"serve_traffic (g): the survivor did not end within {HA_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
        del store
    wall = time.perf_counter() - t0
    got = [ln for ln in text.splitlines() if ln.startswith("HA_RESULT ")]
    if procs[0].returncode != 0 or not got:
        print(text[-4000:], flush=True)
    check(procs[0].returncode == 0 and bool(got),
          f"serve_traffic (g): the survivor exited {procs[0].returncode}")
    check(procs[1].returncode == -9, f"serve_traffic (g): process 1 exited {procs[1].returncode}")
    res = json.loads(got[-1][len("HA_RESULT "):])
    check(res["view"]["world"] == 2 and res["view"]["requests"] == [cfg["ha_requests"]] * 2,
          f"serve_traffic (g): the heartbeat view {res['view']}")
    check(res["local_only"] and res["evicted"] and res["evictions"] == 1,
          f"serve_traffic (g): the guard did not evict ({res})")
    check(res["same"], "serve_traffic (g): the survivor's answers changed after the eviction")
    check(not any(res["launches"].values()), f"serve_traffic (g): launched {res['launches']}")
    hint = Supervisor(lambda *a: [], 1, os.path.join(out, "sideband"))._read_scale_hint()
    check(hint is not None and hint["action"] == "out",
          f"serve_traffic (g): the supervisor read the scale hint {hint}")
    res.update(wall_s=wall, supervisor_hint=hint)
    return res


def phase_serve_traffic(cfg, dev, slab=None, km_model=None, rehearse=False):
    """Phase 29: the serving front on the headline K-Means (module
    docstring).  ``slab`` is the host copy of the blobs' first rows that
    ``km_model`` was fitted on; the ``--traffic`` run fits it first."""
    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.telemetry import fleet as tfleet

    rng = np.random.default_rng(29)
    kc = cfg["kmeans"]
    if km_model is None:
        x, _, _ = blobs(kc["n"], kc["d"], kc["k"], dev, seed=0)
        km_model = KMeans(k=kc["k"], max_iter=kc["max_iter"], tol=1e-4,
                          init_mode="k-means||", seed=0, device=str(dev)).fit(x)
        slab = x[: cfg["slab"]].cpu().numpy()
        del x
    if dev.type != "cuda":
        # no card to detect a budget from: the ladder prices against 1 GB
        set_config(memory_budget_hbm="1G")
    t_phase = time.perf_counter()
    ref = _f64_labels(slab, km_model.cluster_centers_)
    h = serving.serve(km_model)
    t0 = time.perf_counter()
    buckets = h.warmup(cfg["max_rows"])
    warm_s = time.perf_counter() - t0
    a, storm = traffic_a(cfg, h, slab, ref, rng)
    emit("serve_traffic_a", {"warmup_buckets": buckets, "warmup_s": warm_s, **a})
    sink = os.path.join(_scratch("serve_traffic_sink"), "sink.jsonl")
    port = _free_port()
    try:
        b = traffic_b(cfg, h, ref, storm, sink, port)
        emit("serve_traffic_b", b)
        c = traffic_c(cfg, h, km_model, slab, ref, rng)
        emit("serve_traffic_c", c)
        f = traffic_f(port)
        emit("serve_traffic_f", f)
    finally:
        tfleet.stop_server()
        set_config(metrics_port=0, serve_slo_p99_ms=0.0, serve_trace_sample=0.0,
                   telemetry_log="", serve_queue_depth=256, serve_shed_headroom=0.5,
                   serve_brownout="auto", serving_precision="")
    d = traffic_d(cfg, h, km_model, slab, rng, dev)
    emit("serve_traffic_d", d)
    ref = _f64_labels(slab, km_model.cluster_centers_)
    e = traffic_e(cfg, h, slab, ref, rng)
    emit("serve_traffic_e", e)
    g = traffic_g(cfg, km_model, slab, dev, rehearse)
    emit("serve_traffic_g", g)
    summary = serving.serving_summary()
    serving.registry.clear()
    set_config(memory_budget_hbm="", serve_brownout="auto")
    out = {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f, "g": g,
           "wall_s": time.perf_counter() - t_phase}
    emit("serve_traffic", {"wall_s": out["wall_s"], "serving_summary": summary})
    return out


# -- the factor-sharded serving (30) and the Spark-API front doors (31) --------

SHARDED_SERVE = {"n": 10, "world": 4}
SWEEP_TIMEOUT_S = 300
# the front doors: the headline K-Means table, the PCA table, the ALS
# table at rank 32 (the 2-D layout of phase 19), a small pipeline and a
# small table through the pyspark adapter
FRONT_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "pca": (1 << 20, 128),
              "pca_k": 16, "test_rows": 200_000, "cold": 1000, "sil_rows": 1 << 16,
              "pipe": (4096, 32), "spark_rows": 2048}
FRONT_TINY = {"n": 4133, "d": 29, "k": 11, "max_iter": 5, "pca": (3001, 37), "pca_k": 5,
              "test_rows": 2000, "cold": 50, "sil_rows": 1024, "pipe": (512, 12),
              "spark_rows": 256}


class configured:
    """``set_config(**fields)`` for a ``with`` block, the fields' earlier
    values restored after it."""

    def __init__(self, **fields):
        self.fields = fields

    def __enter__(self):
        cfg = config.get_config()
        self.before = {k: getattr(cfg, k) for k in self.fields}
        set_config(**self.fields)

    def __exit__(self, *exc):
        set_config(**self.before)
        return False


def _fit_block(cfg, data, dev, rank, item_layout):
    """The block ALS of phases 12 (rank 10, replicated items) and 19 (rank
    32, the 2-D layout) on four ranks, counts zeroed just before: the
    model keeps its live layout (nothing gathered in the fit)."""
    users, items, ratings = data
    devs = mesh_devices(dev, SHARDED_SERVE["world"])
    with configured(als_item_layout=item_layout):
        als_kernel.reset_launches()
        model = ALS(rank=rank, max_iter=cfg["max_iter"], reg_param=cfg["reg"],
                    implicit_prefs=True, alpha=cfg["alpha"], seed=0,
                    device=",".join(str(v) for v in devs)).fit(
            users, items, ratings, cfg["n_users"], cfg["n_items"])
    check(model.summary.get("sharded_factors") and model._user_factors is None,
          "block ALS: the fit gathered its factors")
    model.fit_launches = dict(als_kernel.LAUNCHES)
    return model


def _sweep_gate(tag, ids, scores, ref_ids, ref_scores):
    """ids equal on >= MIN_AGREEMENT of the users (near-ties may swap),
    scores within 1e-6 of the reference's scale."""
    rows = float(np.mean(np.all(ids == ref_ids, axis=1)))
    rel = float(np.max(np.abs(scores - ref_scores)) / max(np.max(np.abs(ref_scores)), 1e-30))
    check(ids.shape == ref_ids.shape and rows >= MIN_AGREEMENT and rel <= 1e-6,
          f"{tag}: ids equal on {rows:.6f} of the users, scores rel err {rel:.3g}")
    return {"ids_equal_rows": rows, "scores_rel_err": rel}


def _timed_sweep(model, n, devs):
    """The sweep warm, then timed once: ``(ids, scores, wall_s, peak GB by
    card)``."""
    from oap_mllib_tpu_torch.serving import sweep

    sweep.recommend_for_all_users(model, n, with_scores=True)
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    ids, scores = sweep.recommend_for_all_users(model, n, with_scores=True)
    wall = time.perf_counter() - t0
    peak = {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
    return ids, scores, wall, peak


def _sharded_leg(tag, model, cfg, dev):
    """One model's sweep from its live layout against the streamed sweep of
    its gathered tables, the ring hops booked, and the sweep of the same
    tables placed by ``shard_factors_local`` bit-equal to the live one."""
    from oap_mllib_tpu_torch.serving import sweep

    n, world = SHARDED_SERVE["n"], SHARDED_SERVE["world"]
    devs = mesh_devices(dev, world)
    two_d = model._sharded_item is not None
    check(len(als_block.data_ranks(model._sharded_user.mesh)) == world,
          f"{tag}: the live layout has {model._sharded_user.mesh.shape} ranks")
    _zero_launches()
    hops = tel_metrics.family_total("oap_serve_ring_hops_total")
    ids, scores, wall, peak = _timed_sweep(model, n, devs)
    hops = int(tel_metrics.family_total("oap_serve_ring_hops_total") - hops)
    check(hops == (2 * world if two_d else 0),
          f"{tag}: {hops} ring hops over two sweeps, expected {2 * world if two_d else 0}")
    check(not any(_launches().values()), f"{tag}: the sweep launched {_launches()}")
    check(model._sharded_user is not None, f"{tag}: the sweep dropped the live layout")
    uf, itf = model.user_factors_, model.item_factors_
    host = ALSModel(uf, itf, device=str(dev))
    t0 = time.perf_counter()
    ref_ids, ref_scores = sweep.recommend_for_all_users(host, n, with_scores=True)
    ref_wall = time.perf_counter() - t0
    gate = _sweep_gate(tag, ids, scores, ref_ids, ref_scores)
    check(np.all(np.isfinite(scores)) and ids.min() >= 0 and ids.max() < itf.shape[0],
          f"{tag}: ids or scores out of range")
    with configured(device=",".join(str(v) for v in devs)):
        local = ALSModel(None, None if two_d else itf, device=str(devs[0]),
                         sharded_user=sweep.shard_factors_local(uf),
                         sharded_item=sweep.shard_factors_local(itf) if two_d else None)
    l_ids, l_scores = sweep.recommend_for_all_users(local, n, with_scores=True)
    same_local = bool(np.array_equal(l_ids, ids) and np.array_equal(l_scores, scores))
    check(same_local, f"{tag}: the shard_factors_local sweep differs from the live layout's")
    out = {"rank": model.rank, "item_layout": model.summary["item_layout"],
           "n_users": int(uf.shape[0]), "n_items": int(itf.shape[0]), "n": n,
           "fit_launches": getattr(model, "fit_launches", None), "ring_hops": hops // 2,
           "sweep_s": wall, "users_per_s": uf.shape[0] / wall, "peak_mem_gb": peak,
           "streamed_sweep_s": ref_wall, "streamed_users_per_s": uf.shape[0] / ref_wall,
           "vs_streamed": gate, "shard_factors_local_bit_equal": same_local}
    emit(f"serve_sharded_{tag}", out)
    return out, (ids, scores, ref_ids, ref_scores)


def sweep_worker(argv) -> int:
    """One process of the two-process leg of phase 30: the host tables
    placed on the world's block layout by ``shard_factors``, swept; then
    process 1 SIGKILLs itself, and process 0's heartbeat evicts it, its
    next sweep is refused and re-forms on its own card."""
    import signal

    from oap_mllib_tpu_torch import serving
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.serving import ha, sweep
    from oap_mllib_tpu_torch.utils import recovery

    rank, port, out, device = int(argv[0]), int(argv[1]), argv[2], argv[3]
    n = SHARDED_SERVE["n"]
    set_config(device=device, crash_dir=os.path.join(out, "sideband"), collective_timeout=60.0)
    bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, rank, launcher_store=True)
    uf, itf = np.load(os.path.join(out, "uf.npy")), np.load(os.path.join(out, "itf.npy"))
    mesh = get_mesh()
    model = ALSModel(None, None, device=device, sharded_user=sweep.shard_factors(uf, mesh),
                     sharded_item=sweep.shard_factors(itf, mesh))
    hops = tel_metrics.family_total("oap_serve_ring_hops_total")
    t0 = time.perf_counter()
    ids, scores = sweep.recommend_for_all_users(model, n, with_scores=True)
    wall = time.perf_counter() - t0
    np.save(os.path.join(out, f"ids{rank}.npy"), ids)
    np.save(os.path.join(out, f"scores{rank}.npy"), scores)
    guard = serving.ReplicaGuard()
    with guard.leg():
        view = serving.heartbeat()
    res = {"rank": rank, "world": view["world"], "sweep_s": wall,
           "hops": int(tel_metrics.family_total("oap_serve_ring_hops_total") - hops)}
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    with guard.leg():
        serving.heartbeat()
    reforms = tel_metrics.family_total("oap_serve_sweep_reforms_total")
    errors = []

    def reform(exc):
        errors.append(type(exc).__name__)
        return ALSModel(None, None, device=device, sharded_user=sweep.shard_factors_local(uf),
                        sharded_item=sweep.shard_factors_local(itf))

    t0 = time.perf_counter()
    ids, scores = sweep.recommend_for_all_users(model, n, with_scores=True, reform=reform)
    res.update(evicted=ha.fleet_evicted(), errors=errors, reform_sweep_s=time.perf_counter() - t0,
               reforms=int(tel_metrics.family_total("oap_serve_sweep_reforms_total") - reforms))
    np.save(os.path.join(out, "ids_reformed.npy"), ids)
    np.save(os.path.join(out, "scores_reformed.npy"), scores)
    print("SWEEP_RESULT " + json.dumps(res), flush=True)
    recovery.exit_now(0)
    return 0


def sharded_world(uf, itf, ref, dev, rehearse):
    """Phase 30's two-process leg in world "a" (two processes on the one
    card): both sweep the 2-D placement of the tables and agree bit for
    bit; process 1 dies by SIGKILL; the survivor re-forms once and
    answers as the host reference does."""
    import datetime

    import torch.distributed as dist

    out = _scratch("serve_sharded_world")
    np.save(os.path.join(out, "uf.npy"), uf)
    np.save(os.path.join(out, "itf.npy"), itf)
    store = dist.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=SWEEP_TIMEOUT_S))
    flags = ["--rehearse"] if rehearse else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sweep-worker",
                               str(r), str(store.port), out, str(dev), *flags],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        text = procs[0].communicate(timeout=SWEEP_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        raise Failed(f"serve_sharded (world): the survivor did not end within {SWEEP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
        del store
    wall = time.perf_counter() - t0
    got = [ln for ln in text.splitlines() if ln.startswith("SWEEP_RESULT ")]
    if procs[0].returncode != 0 or not got:
        print(text[-4000:], flush=True)
    check(procs[0].returncode == 0 and bool(got),
          f"serve_sharded (world): the survivor exited {procs[0].returncode}")
    check(procs[1].returncode == -9,
          f"serve_sharded (world): process 1 exited {procs[1].returncode}")
    res = json.loads(got[-1][len("SWEEP_RESULT "):])
    load = {name: np.load(os.path.join(out, f"{name}.npy"))
            for name in ("ids0", "ids1", "scores0", "scores1", "ids_reformed",
                         "scores_reformed")}
    same = bool(np.array_equal(load["ids0"], load["ids1"])
                and np.array_equal(load["scores0"], load["scores1"]))
    check(same, "serve_sharded (world): the two processes' sweeps differ")
    check(res["world"] == 2 and res["hops"] == 2,
          f"serve_sharded (world): world {res['world']}, {res['hops']} hops")
    check(res["evicted"] and res["errors"] == ["PeerAbortError"] and res["reforms"] == 1,
          f"serve_sharded (world): the survivor did not re-form once ({res})")
    ref_ids, ref_scores = ref
    res.update(wall_s=wall, processes_bit_equal=same,
               vs_streamed=_sweep_gate("serve_sharded (world)", load["ids0"], load["scores0"],
                                       ref_ids, ref_scores),
               reformed_vs_streamed=_sweep_gate("serve_sharded (world, re-formed)",
                                                load["ids_reformed"],
                                                load["scores_reformed"], ref_ids, ref_scores))
    emit("serve_sharded_world", res)
    return res


def phase_serve_sharded(als_cfg, data, dev, rehearse, replicated=None, two_d=None):
    """Phase 30: the factor-sharded serving on the ML-25M models of the
    block fits (phase 12's rank 10 with replicated items, phase 19's rank
    32 on the 2-D layout; fitted here when not given), then the world."""
    t0 = time.perf_counter()
    replicated = replicated or _fit_block(als_cfg, data, dev, als_cfg["rank"], "auto")
    two_d = two_d or _fit_block(als_cfg, data, dev, als_cfg["wide_rank"], als_cfg["layout_2d"])
    check(replicated._sharded_item is None and two_d._sharded_item is not None,
          "serve_sharded: the item layouts are not replicated and 2-D")
    out = {}
    out["replicated"], (_, _, ref_ids, ref_scores) = _sharded_leg("replicated", replicated,
                                                                  als_cfg, dev)
    out["two_d"], two_d_result = _sharded_leg("two_d", two_d, als_cfg, dev)
    out["world"] = sharded_world(replicated.user_factors_, replicated.item_factors_,
                                 (ref_ids, ref_scores), dev, rehearse)
    emit("serve_sharded", {"users_per_s": {k: out[k]["users_per_s"]
                                           for k in ("replicated", "two_d")},
                           "world_wall_s": out["world"]["wall_s"],
                           "wall_s": time.perf_counter() - t0})
    return out, two_d_result


class FakeSession:
    """The duck-typed SparkSession surface the pyspark adapter touches."""

    def createDataFrame(self, data, schema):
        return FakeDataFrame({name: [row[j] for row in data] for j, name in enumerate(schema)},
                             self)


class FakeDataFrame:
    """The duck-typed DataFrame surface the pyspark adapter touches:
    select, collect, columns, sparkSession."""

    def __init__(self, columns, session):
        self._cols, self.sparkSession = columns, session

    @property
    def columns(self):
        return list(self._cols)

    def select(self, *names):
        return FakeDataFrame({n: self._cols[n] for n in names}, self.sparkSession)

    def collect(self):
        names = list(self._cols)
        n = len(self._cols[names[0]]) if names else 0
        return [tuple(self._cols[c][i] for c in names) for i in range(n)]


def front_kmeans(cfg, dev, km_ref):
    """(a) the compat K-Means at the headline shape: K1 as often as the
    native fit, centers bit-equal to it; transform and the silhouette of
    a slice."""
    from oap_mllib_tpu_torch.compat import spark

    x_dev = blobs(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)[0]
    if km_ref is None:
        kmeans_kernel.reset_launches()
        native = KMeans(k=cfg["k"], max_iter=cfg["max_iter"], tol=1e-4, init_mode="k-means||",
                        seed=0, device=str(dev)).fit(x_dev)
        km_ref = (dict(kmeans_kernel.LAUNCHES), native.cluster_centers_)
    x = x_dev.cpu().numpy()
    del x_dev
    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    model = (spark.KMeans().setK(cfg["k"]).setMaxIter(cfg["max_iter"]).setInitMode("k-means||")
             .setSeed(0).fit({"features": x}))
    wall = time.perf_counter() - t0
    launches = dict(kmeans_kernel.LAUNCHES)
    check(launches == km_ref[0], f"front_doors (a): K1 {launches}, the native fit {km_ref[0]}")
    same = bool(np.array_equal(model.clusterCenters(), km_ref[1]))
    check(same, "front_doors (a): the compat centers differ from the native fit's")
    rows = cfg["sil_rows"]
    pred = model.transform({"features": x})
    check(pred["prediction"].shape == (cfg["n"],) and set(pred) == {"features", "prediction"},
          "front_doors (a): transform columns")
    sil = spark.ClusteringEvaluator().evaluate(
        {"features": x[:rows], "prediction": pred["prediction"][:rows]})
    check(np.isfinite(sil) and -1.0 <= sil <= 1.0, f"front_doors (a): silhouette {sil}")
    return {"launches": launches, "centers_bit_equal": same, "wall_s": wall,
            "num_iter": model.summary.num_iter, "silhouette_rows": rows, "silhouette": sil}


def front_pca(cfg, dev):
    """(b) the compat PCA: two K2 launches, components against the native
    fit of the same table (sign-insensitive)."""
    from oap_mllib_tpu_torch.compat import spark

    n, d = cfg["pca"]
    x_dev = pca_data(n, d, dev, seed=d)
    native = PCA(k=cfg["pca_k"], device=str(dev)).fit(x_dev)
    x = x_dev.cpu().numpy()
    del x_dev
    pca_kernel.reset_launches()
    t0 = time.perf_counter()
    model = spark.PCA().setK(cfg["pca_k"]).fit({"features": x})
    wall = time.perf_counter() - t0
    launches = dict(pca_kernel.LAUNCHES)
    expect = 2 if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == expect,
          f"front_doors (b): K2 launched {launches[pca_kernel.KERNEL]}, expected {expect}")
    err = sign_err(model.pc, native.components_)
    check(err <= PCA_FIT_TOL, f"front_doors (b): components {err:.3g} from the native fit")
    proj = model.transform({"features": x[:4096]})["pcaFeatures"]
    check(proj.shape == (min(4096, n), cfg["pca_k"]) and np.all(np.isfinite(proj)),
          "front_doors (b): transform")
    return {"launches": launches, "components_err": err, "wall_s": wall,
            "bit_equal": bool(np.array_equal(model.pc, native.components_))}


def front_als(cfg, als_cfg, data, dev, two_d_result, block_launches):
    """(c) the compat ALS at the ML-25M table with setNumUserBlocks(4) on
    the four ranks (rank 32, the 2-D layout of phase 19): K3 / K4 as the
    native block fit, the live layout kept, transform with "drop",
    recommendForAllUsers through the ring sweep bit-equal to phase 30's
    sweep of the native fit, the RegressionEvaluator."""
    from oap_mllib_tpu_torch.compat import spark

    users, items, ratings = data
    devs = mesh_devices(dev, SHARDED_SERVE["world"])
    df = {"user": users, "item": items, "rating": ratings}
    with configured(device=",".join(str(v) for v in devs), als_item_layout=als_cfg["layout_2d"]):
        als_kernel.reset_launches()
        t0 = time.perf_counter()
        model = (spark.ALS().setRank(als_cfg["wide_rank"]).setMaxIter(als_cfg["max_iter"])
                 .setRegParam(als_cfg["reg"]).setAlpha(als_cfg["alpha"]).setImplicitPrefs(True)
                 .setSeed(0).setNumUserBlocks(SHARDED_SERVE["world"])
                 .setColdStartStrategy("drop").fit(df))
        wall = time.perf_counter() - t0
        launches = dict(als_kernel.LAUNCHES)
        inner = model._inner
        s = inner.summary
        check(s["sharded_factors"] and s["item_layout"] == "sharded"
              and inner._user_factors is None and s["num_user_blocks"] == SHARDED_SERVE["world"],
              f"front_doors (c): the block fit's layout {s.get('item_layout')}")
        hops = tel_metrics.family_total("oap_serve_ring_hops_total")
        t0 = time.perf_counter()
        ids, scores = model.recommendForAllUsers(SHARDED_SERVE["n"], withScores=True)
        sweep_s = time.perf_counter() - t0
        hops = int(tel_metrics.family_total("oap_serve_ring_hops_total") - hops)
    check(launches == block_launches,
          f"front_doors (c): K3 / K4 {launches}, the native block fit {block_launches}")
    check(hops == SHARDED_SERVE["world"] and inner._user_factors is None,
          f"front_doors (c): {hops} ring hops, the factors gathered: "
          f"{inner._user_factors is not None}")
    same = bool(np.array_equal(ids, two_d_result[0]) and np.array_equal(scores, two_d_result[1]))
    check(same, "front_doors (c): recommendForAllUsers differs from the native fit's sweep")
    rows, cold = cfg["test_rows"], cfg["cold"]
    test = {"user": np.concatenate([users[:rows], als_cfg["n_users"] + np.arange(cold)]),
            "item": np.concatenate([items[:rows], items[:cold]]),
            "rating": np.concatenate([ratings[:rows], ratings[:cold]])}
    t0 = time.perf_counter()
    out = model.transform(test)
    transform_s = time.perf_counter() - t0
    check(len(out["prediction"]) == rows and np.all(np.isfinite(out["prediction"])),
          f"front_doors (c): transform kept {len(out['prediction'])} of {rows + cold} rows")
    want = inner.predict(users[:rows], items[:rows])
    check(np.allclose(out["prediction"], want, rtol=1e-6, atol=1e-6),
          "front_doors (c): transform differs from the model's predict")
    rmse = spark.RegressionEvaluator(metricName="rmse", labelCol="rating").evaluate(out)
    direct = float(np.sqrt(np.mean((out["prediction"].astype(np.float64)
                                    - ratings[:rows].astype(np.float64)) ** 2)))
    check(abs(rmse - direct) <= 1e-9 * max(1.0, direct),
          f"front_doors (c): rmse {rmse} against {direct}")
    return {"launches": launches, "wall_s": wall, "ring_hops": hops, "sweep_s": sweep_s,
            "sweep_bit_equal_to_native": same, "transform_rows": rows + cold,
            "transform_kept": int(len(out["prediction"])), "transform_s": transform_s,
            "rmse": rmse}


def front_pipeline(cfg, dev):
    """(d) a small Pipeline (PCA, then K-Means) fitted, saved, loaded and
    run: bit-equal to the fitted one."""
    from oap_mllib_tpu_torch.compat import pipeline, spark

    n, d = cfg["pipe"]
    x = np.random.default_rng(5).normal(size=(n, d)).astype(np.float32)
    pm = pipeline.Pipeline(stages=[
        spark.PCA().setK(4).setOutputCol("pca"),
        spark.KMeans().setK(8).setSeed(1).setInitMode("random").setFeaturesCol("pca")]).fit(
        {"features": x})
    path = _scratch("front_pipeline")
    pm.save(path)
    back = pipeline.PipelineModel.load(path)
    a, b = pm.transform({"features": x}), back.transform({"features": x})
    same = bool(np.array_equal(a["pca"], b["pca"])
                and np.array_equal(a["prediction"], b["prediction"]))
    check(same, "front_doors (d): the loaded pipeline's output differs")
    shutil.rmtree(path, ignore_errors=True)
    return {"rows": n, "bit_equal": same}


def front_pyspark(cfg, dev):
    """(e) the pyspark adapter on a duck-typed DataFrame (no pyspark): the
    K-Means and ALS adapters against the dict plane on the same rows."""
    from oap_mllib_tpu_torch.compat import pyspark, spark

    rng = np.random.default_rng(9)
    n = cfg["spark_rows"]
    x = (rng.normal(size=(8, 16)) * 6)[rng.integers(8, size=n)] + rng.normal(size=(n, 16))
    sess = FakeSession()
    df = FakeDataFrame({"features": [list(r) for r in x]}, sess)
    out = pyspark.KMeans(k=8, seed=1).fit(df).transform(df)
    want = spark.KMeans().setK(8).setSeed(1).fit({"features": x}).transform({"features": x})
    labels = [r[-1] for r in out.collect()]
    check(out.columns == ["features", "prediction"]
          and labels == [int(v) for v in want["prediction"]],
          "front_doors (e): the K-Means adapter differs from the dict plane")
    u, i = rng.integers(0, 60, n), rng.integers(0, 40, n)
    r = rng.random(n).astype(np.float32)
    rdf = FakeDataFrame({"userId": [int(v) for v in u], "movieId": [int(v) for v in i],
                         "rating": [float(v) for v in r]}, sess)
    kw = dict(rank=4, maxIter=3, userCol="userId", itemCol="movieId", ratingCol="rating",
              coldStartStrategy="drop")
    als_rows = pyspark.ALS(**kw).fit(rdf).transform(rdf).collect()
    dict_model = spark.ALS().setRank(4).setMaxIter(3).setUserCol("userId").setItemCol(
        "movieId").setColdStartStrategy("drop").fit({"userId": u, "movieId": i, "rating": r})
    want = dict_model.transform({"userId": u, "movieId": i, "rating": r})["prediction"]
    same = bool(np.array_equal(np.asarray([row[-1] for row in als_rows], np.float32), want))
    check(same, "front_doors (e): the ALS adapter differs from the dict plane")
    return {"rows": n, "kmeans_equal": True, "als_equal": same,
            "have_pyspark": pyspark.HAVE_PYSPARK}


def front_examples(dev):
    """(f) the port's examples through their run_all.sh on this device,
    each exit 0."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oap_mllib_tpu_torch",
                          "examples", "run_all.sh")
    t0 = time.perf_counter()
    done = subprocess.run(["bash", script, "--device", "cuda" if dev.type == "cuda" else "cpu"],
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    ran = done.stdout.count("=== ")
    if done.returncode != 0:
        print(done.stdout[-3000:], done.stderr[-3000:], flush=True)
    check(done.returncode == 0 and ran == 9 and "All examples completed." in done.stdout,
          f"front_doors (f): run_all.sh exited {done.returncode} after {ran} examples")
    return {"examples": ran, "wall_s": wall}


def phase_front_doors(cfg, als_cfg, data, dev, two_d_result, block_launches, km_ref=None):
    """Phase 31: the Spark-API front doors, their fits on ``Config.device``
    (this device; the ALS leg's four ranks)."""
    t0 = time.perf_counter()
    with configured(device=str(dev)):
        out = {"a_kmeans": front_kmeans(cfg, dev, km_ref), "b_pca": front_pca(cfg, dev),
               "c_als": front_als(cfg, als_cfg, data, dev, two_d_result, block_launches),
               "d_pipeline": front_pipeline(cfg, dev), "e_pyspark": front_pyspark(cfg, dev)}
    out["f_examples"] = front_examples(dev)
    out["wall_s"] = time.perf_counter() - t0
    emit("front_doors", out)
    return out


# -- the kernel-geometry autotuner and the trace merger (32) --------------------

# leg 1 at the main paths' shapes; legs 2-3 fit smaller tables in the
# main paths' buckets (K-Means (1024, 256), PCA (128,), ALS (16,)), so
# the sweeps rank geometry where the headline fits run
TUNE_FULL = {"kmeans": FULL, "kmeans_modes": ("highest", "default"),
             "pca": (1 << 20, 128), "pca_modes": ("highest", "high"), "als": ALS_FULL,
             "sharded": SHARDED_FULL, "ring": (1000, 130), "reps": 3,
             "fit_kmeans": {"n": 1 << 18, "d": 256, "k": 1000, "max_iter": 3},
             "fit_pca": {"n": 1 << 18, "d": 128, "k": 16},
             "fit_als": {"n_users": 20_000, "n_items": 5_000, "nnz": 400_000, "rank": 10,
                         "alpha": 40.0, "reg": 0.1, "max_iter": 2},
             "world": {"n": 1 << 18, "d": 256, "k": 1000, "max_iter": 3}}
TUNE_TINY = {"kmeans": TINY, "kmeans_modes": ("highest", "default"),
             "pca": (3001, 37), "pca_modes": ("highest", "high"), "als": ALS_TINY,
             "sharded": SHARDED_TINY, "ring": (13, 37), "reps": 1,
             "fit_kmeans": {"n": 4133, "d": 29, "k": 11, "max_iter": 3},
             "fit_pca": {"n": 3001, "d": 37, "k": 5},
             "fit_als": {"n_users": 300, "n_items": 120, "nnz": 5_000, "rank": 10,
                         "alpha": 40.0, "reg": 0.1, "max_iter": 2},
             "world": {"n": 4096, "d": 29, "k": 11, "max_iter": 3}}
# a knob that changes the fold: values within this share of max(1, max|ref|)
TUNE_FOLD_RTOL = 1e-6
# a non-default geometry for every kernel of the fits (leg 3)
TUNE_PINS = {"kmeans": {"range_rows": 4096, "parts": 4},
             "pca": {"target_blocks": 1056, "sum_rows": 4096},
             "als_solve": {"group": 1}, "als_gram": {"blocks": 132, "stage_floats": 2048}}
TUNE_FITS = ("kmeans", "pca", "als")
# the kernels each fit of leg 2 resolves and sweeps once
TUNE_SWEPT = {"kmeans": ["kmeans"], "pca": ["pca"], "als": ["als_solve", "als_gram"]}


def json_pin(pins):
    return "pin:" + json.dumps(pins, sort_keys=True)


def _fold_err(a, ref):
    """max |a - ref| over max(1, max |ref|): the contract's measure for a
    knob that changes the fold."""
    return float(torch.max(torch.abs(a - ref)) / max(1.0, float(torch.max(torch.abs(ref)))))


def _tune_hold(tag, got, ref, bit_equal):
    """One candidate's outputs against the default's: every bit, or within
    :data:`TUNE_FOLD_RTOL`; returns the worst error."""
    err = max(_fold_err(a, b) for a, b in zip(got, ref))
    if bit_equal:
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"{tag}: not bit-equal to the default geometry (err {err:.3g})")
    check(err <= TUNE_FOLD_RTOL, f"{tag}: {err:.3g} from the default geometry")
    return err


def _k1_run(x, w, c, mode, geo):
    """(sums, counts, labels) of K1 at a geometry; the plain version and its
    labels on the CPU."""
    if x.device.type == "cuda":
        sums, counts, _, labels = kmeans_kernel._launch(x, w, c, mode, False, geo)
        return sums, counts, labels.long()
    sums, counts, _ = kmeans_kernel.lloyd_accumulate(x, w, c, mode, False, geo)
    return sums, counts, kmeans_kernel.assign_plain(x, c, mode, False)[0]


def tune_kmeans_candidates(cfg, dev, reps):
    """K1's grid at the main path's table, each tier: labels equal to the
    default's, sums and counts bit-equal where only ``range_rows`` moves
    (a stable sort) and within the fold bound where ``parts`` does, and
    every candidate against the plain version's sums on its labels."""
    kc = cfg["kmeans"]
    x, w, c = blobs(kc["n"], kc["d"], kc["k"], dev, seed=0)
    bucket = autotune.shape_bucket(kc["k"], kc["d"])
    out = []
    for mode in cfg["kmeans_modes"]:
        ref = _k1_run(x, w, c, mode, None)
        ref_s, ref_c = kmeans_kernel.sums_for_labels(x, w, ref[2], kc["k"], mode)
        for cand in autotune.candidates("kmeans", bucket):
            tag = f"tuning kmeans {mode} {cand}"
            got = _k1_run(x, w, c, mode, cand)
            check(torch.equal(got[2], ref[2]), f"{tag}: labels differ from the default's")
            err = _tune_hold(tag, got[:2], ref[:2],
                             cand["parts"] == autotune.DEFAULTS["kmeans"]["parts"])
            plain = max(_rel_err(got[0], ref_s), _rel_err(got[1], ref_c))
            check(plain <= RTOL[mode], f"{tag}: {plain:.3g} from the plain version")
            out.append({"mode": mode, "geometry": cand, "fold_err": err, "plain_rel_err": plain,
                        "ms": time_ms(lambda: _k1_run(x, w, c, mode, cand), dev, reps)})
    return out


def tune_pca_candidates(cfg, dev, reps):
    """K2's grid at the main path's table, each tier: both passes within
    the fold bound of the default and held to the plain version."""
    n, d = cfg["pca"]
    x = pca_data(n, d, dev, seed=d)
    mask = torch.ones(n, device=dev)
    out = []
    for mode in cfg["pca_modes"]:
        def run(geo):
            _, cs, cnt = pca_kernel.pca_moments(x, mask, None, mode, need_gram=False,
                                                geometry=geo)
            g, _, _ = pca_kernel.pca_moments(x, mask, cs / float(n), mode, need_sums=False,
                                             geometry=geo)
            return g, cs, cnt.reshape(1)

        ref = run(None)
        g_p, cs_p, _ = pca_kernel.pca_moments_plain(x, mask, ref[1] / float(n), mode)
        for cand in autotune.candidates("pca", autotune.shape_bucket(d)):
            tag = f"tuning pca {mode} {cand}"
            got = run(cand)
            err = _tune_hold(tag, got, ref, False)
            check(torch.equal(got[2], ref[2]), f"{tag}: the row count differs")
            e_sum, e_gram = _rel_err(got[1], cs_p), _rel_err(got[0], g_p)
            check(e_sum <= PCA_SUM_RTOL and e_gram <= PCA_GRAM_RTOL[mode],
                  f"{tag}: colsum {e_sum:.3g}, Gram {e_gram:.3g} from the plain version")
            out.append({"mode": mode, "geometry": cand, "fold_err": err,
                        "plain_rel_err": {"colsum": e_sum, "gram": e_gram},
                        "ms": time_ms(lambda: run(cand), dev, reps)})
    return out


def tune_als_candidates(cfg, dev, reps):
    """K3's grid (every bit: the solve is row-independent) and K4's (the
    fold bound) at the ML-25M user side, r = 10 and r = 32, each against
    the plain version too."""
    ac = cfg["als"]
    users, items, ratings = als_data(ac)
    by_user = als_ops.build_grouped_edges(users, items, ratings, ac["n_users"])
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    solves, grams = [], []
    for r in ac["ranks"]:
        side = als_ops.prepare_grouped(*by_user, ac["n_users"], r, dev)
        y = torch.randn((ac["n_items"], r), generator=g, device=dev) / r ** 0.5
        xf = torch.randn((ac["n_users"], r), generator=g, device=dev) / r ** 0.5
        a, b, n_reg = side.partials(y, ac["alpha"], True)
        gm = als_kernel.factor_gram_plain(y)
        ref = als_kernel.solve_normal_eq(a, b, n_reg, ac["reg"], gm)
        plain = als_kernel.solve_plain(a, b, n_reg, ac["reg"], gm)
        valid = n_reg > 0
        bucket = autotune.shape_bucket(r)
        for cand in autotune.candidates("als_solve", bucket):
            tag = f"tuning als_solve r={r} {cand}"
            w = als_kernel.solve_normal_eq(a, b, n_reg, ac["reg"], gm, geometry=cand)
            check(torch.equal(w, ref), f"{tag}: not bit-equal to the default geometry")
            check(torch.equal(w[valid], plain[valid]), f"{tag}: not bit-equal to the plain version")
            solves.append({"r": r, "geometry": cand, "lanes": als_kernel.solve_lanes(r, cand),
                           "bit_equal": True,
                           "ms": time_ms(lambda: als_kernel.solve_normal_eq(
                               a, b, n_reg, ac["reg"], gm, geometry=cand), dev, reps)})
        ref_g = als_kernel.factor_gram(xf)
        plain_g = als_kernel.factor_gram_plain(xf)
        for cand in autotune.candidates("als_gram", bucket):
            tag = f"tuning als_gram r={r} {cand}"
            gk = als_kernel.factor_gram(xf, "highest", cand)
            err = _tune_hold(tag, [gk], [ref_g], False)
            check(dev.type != "cuda" or torch.equal(gk, gk.T), f"{tag}: not bit-symmetric")
            e_plain = _rel_err(gk, plain_g)
            check(e_plain <= 1e-5, f"{tag}: {e_plain:.3g} from the plain version")
            grams.append({"r": r, "geometry": cand, "fold_err": err, "plain_rel_err": e_plain,
                          "launch": als_kernel.factor_gram_geometry(
                              ac["n_users"], r, cand["blocks"], cand["stage_floats"])._asdict(),
                          "ms": time_ms(lambda: als_kernel.factor_gram(xf, "highest", cand),
                                        dev, reps)})
        del side, a, b, n_reg
    return solves, grams


def _sharded_tuned(sc, dev, segments, x):
    """The model-sharded fit on one card under ``pin:{"ring": {"segments":
    s}}``, the counts zeroed just before and read just after."""
    layout = ",".join(str(q) for q in [dev] * (sc["data"] * sc["model"]))
    set_config(model_parallel=sc["model"], tuning=json_pin({"ring": {"segments": segments}}))
    try:
        _zero_launches()
        t0 = time.perf_counter()
        m = KMeans(k=sc["k"], max_iter=sc["max_iter"], tol=1e-4, seed=0, device=layout).fit(x)
        wall = time.perf_counter() - t0
        launches = _launches()
    finally:
        set_config(model_parallel=1, tuning="auto")
    check([d["geometry"] for d in m.summary.tuning["decisions"]] == [{"segments": segments}],
          f"sharded fit segments={segments}: resolved {m.summary.tuning['decisions']}")
    return m, launches, wall


def tune_ring_candidates(cfg, dev, reps):
    """K5's grid: the ring at the sharded fit's packed buffer (world 2)
    against its plain version bit for bit at each segment count, and the
    model-sharded fit on one card at each: bit-equal to one segment (two
    ranks on the data axis add two values, in either order) and K5's
    launches unchanged."""
    rows, cols = cfg["ring"]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    parts = [torch.randn((rows, cols), generator=g, device=dev) for _ in range(2)]
    rings = []
    for cand in autotune.CANDIDATES["ring"]:
        s = cand["segments"]
        got = ring_kernel.ring_allreduce(parts, s)
        want = ring_kernel.ring_allreduce_plain(parts, s)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"tuning ring segments={s}: not bit-equal to the plain version")
        rings.append({"segments": s, "shape": [rows, cols], "world": 2,
                      "ms": time_ms(lambda: ring_kernel.ring_allreduce(parts, s), dev, reps)})
    sc = cfg["sharded"]
    x, _, _ = blobs(sc["n"], sc["d"], sc["k"], dev, seed=0)
    fits = {}
    for cand in autotune.CANDIDATES["ring"]:
        s = cand["segments"]
        m, launches, wall = _sharded_tuned(sc, dev, s, x)
        fits[s] = (m, launches)
        rings.append({"segments": s, "fit_wall_s": wall, "num_iter": m.summary.num_iter,
                      "launches": launches})
    ref, ref_l = fits[1]
    for s, (m, launches) in fits.items():
        check(np.array_equal(m.cluster_centers_, ref.cluster_centers_)
              and m.summary.num_iter == ref.summary.num_iter,
              f"sharded fit segments={s}: not bit-equal to one segment")
        check(launches == ref_l, f"sharded fit segments={s}: launches {launches}, one "
                                 f"segment {ref_l}")
    want = (ref.summary.num_iter + 1) * sc["model"] if dev.type == "cuda" else 0
    check(ref_l[ring_kernel.KERNEL] == want,
          f"sharded fit: K5 launched {ref_l[ring_kernel.KERNEL]} times, expected {want}")
    return rings, fits[2][1]


def _tune_data(cfg, dev):
    """The tables of legs 2 and 3, made from seeds (any process makes the
    same): the blobs and centers near the blob centers, the PCA table,
    the ratings."""
    kc, pc, ac = cfg["fit_kmeans"], cfg["fit_pca"], cfg["fit_als"]
    x, _, c0 = blobs(kc["n"], kc["d"], kc["k"], dev, seed=3)
    return x, c0, pca_data(pc["n"], pc["d"], dev, seed=7), als_data(ac)


def _tune_fits(cfg, dev, data, which=TUNE_FITS):
    """The fits ``which`` of legs 2 and 3, each with the counts zeroed just
    before and read just after: ``{fit: (arrays, summary, launches)}``."""
    kc, pc, ac = cfg["fit_kmeans"], cfg["fit_pca"], cfg["fit_als"]
    x, _, xp, (u, i, r) = data
    runs = {
        "kmeans": lambda: KMeans(k=kc["k"], max_iter=kc["max_iter"], tol=1e-4, seed=0,
                                 init_mode="random", device=str(dev)).fit(x),
        "pca": lambda: PCA(k=pc["k"], device=str(dev)).fit(xp),
        "als": lambda: ALS(rank=ac["rank"], max_iter=ac["max_iter"], reg_param=ac["reg"],
                           alpha=ac["alpha"], implicit_prefs=True, seed=0,
                           device=str(dev)).fit(u, i, r, ac["n_users"], ac["n_items"]),
    }
    out = {}
    for fit in which:
        _zero_launches()
        m = runs[fit]()
        launches = _launches()
        if fit == "kmeans":
            arrays, s = [m.cluster_centers_], m.summary
        elif fit == "pca":
            arrays, s = [m.components_, m.explained_variance_], m.summary
        else:
            arrays, s = [m.user_factors_, m.item_factors_], m.summary
        out[fit] = (arrays, s, launches)
    return out


def _summary_tuning(s):
    return s["tuning"] if isinstance(s, dict) else s.tuning


def _fit_launches_ok(fit, s, launches, dev, cfg):
    """The fit launched what it launches untuned: the sweeps' launches are
    not the fit's."""
    on = dev.type == "cuda"
    if fit == "kmeans":
        want = {kmeans_kernel.KERNEL: (s.num_iter + 1) if on else 0}
    elif fit == "pca":
        want = {pca_kernel.KERNEL: 2 if on else 0}
    else:
        n = 2 * cfg["fit_als"]["max_iter"] if on else 0
        want = {als_kernel.SOLVE: n, als_kernel.GRAM: n}
    got = {k: launches[k] for k in want}
    check(got == want, f"tuning {fit}: launched {got}, an untuned fit launches {want}")


def _sweeps_of(timings):
    """Every sweep the fit's span tree booked: kernel, bucket, candidates,
    winner and wall."""
    return [sw for _, sp in timings.root.walk() if sp.name == "tuning"
            for sw in sp.attrs.get("sweeps", [])]


def _tuning_counters():
    out = {}
    for fam in ("oap_tuning_hits_total", "oap_tuning_misses_total", "oap_tuning_sweeps_total"):
        for kernel in autotune.KNOBS:
            out[f"{fam}{{kernel={kernel}}}"] = tel_metrics.counter(fam, {"kernel": kernel}).value
    return out


def tune_worker(argv) -> int:
    """The child of leg 2: the same three fits in a fresh process sharing
    the cache directory; its arrays to ``out`` and one ``TUNE_RESULT``
    line of decisions and counters."""
    cache_dir, out = argv[0], argv[1]
    rehearse = "--rehearse" in argv
    dev = resolve_device("cpu" if rehearse else "cuda")
    cfg = TUNE_TINY if rehearse else TUNE_FULL
    set_config(tuning="on", tuning_cache_dir=cache_dir)
    before = _tuning_counters()
    try:
        fits = _tune_fits(cfg, dev, _tune_data(cfg, dev))
        for fit, (arrays, s, launches) in fits.items():
            _fit_launches_ok(fit, s, launches, dev, cfg)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    after = _tuning_counters()
    np.savez(out, **{f"{fit}_{j}": a for fit, (arrays, _, _) in fits.items()
                     for j, a in enumerate(arrays)})
    print("TUNE_RESULT " + json.dumps({
        "tuning": {fit: _summary_tuning(s) for fit, (_, s, _) in fits.items()},
        "counters": {k: after[k] - before[k] for k in after}}), flush=True)
    return 0


def tune_cache_contract(cfg, dev, rehearse):
    """Leg 2: under ``tuning="on"`` with a fresh cache directory each fit
    sweeps every kernel it launches exactly once (its summary and the
    counters), then a second process sharing the directory resolves every
    kernel as a hit with no sweep, picks the same geometry and gives every
    array bit for bit."""
    cache_dir = _scratch("tuning_cache")
    data = _tune_data(cfg, dev)
    set_config(tuning="on", tuning_cache_dir=cache_dir)
    before = _tuning_counters()
    try:
        fits = _tune_fits(cfg, dev, data)
    finally:
        set_config(tuning="auto", tuning_cache_dir="")
    after = _tuning_counters()
    res = {"sweeps": [], "parent": {}}
    for fit, (arrays, s, launches) in fits.items():
        _fit_launches_ok(fit, s, launches, dev, cfg)
        t = _summary_tuning(s)
        kernels = [d["kernel"] for d in t["decisions"]]
        check(kernels == TUNE_SWEPT[fit] and t["sweeps"] == len(kernels) and t["hits"] == 0
              and all(d["decision"] == "sweep" for d in t["decisions"]),
              f"tuning {fit}: decisions {t['decisions']}")
        for sw in _sweeps_of(s["timings"] if isinstance(s, dict) else s.timings):
            res["sweeps"].append(sw)
            print(f"tuning sweep {sw['kernel']} bucket={sw['bucket']}: {sw['wall_s']:.3f} s, "
                  f"{sw['candidates']} candidates, winner {sw['winner']}", flush=True)
        res["parent"][fit] = t
    for kernel in ("kmeans", "pca", "als_solve", "als_gram"):
        key = f"oap_tuning_sweeps_total{{kernel={kernel}}}"
        check(after[key] - before[key] == 1, f"tuning: {key} rose by {after[key] - before[key]}")
    check(len(res["sweeps"]) == 4, f"tuning: the span trees booked {len(res['sweeps'])} sweeps")
    check(len(os.listdir(cache_dir)) == 4, f"tuning: {len(os.listdir(cache_dir))} cache files")
    out = os.path.join(cache_dir, "child.npz")
    flags = ["--rehearse"] if rehearse else []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--tune-worker", cache_dir,
                        out, *flags], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=MP_TIMEOUT_S)
    res["child_wall_s"] = time.perf_counter() - t0
    for line in p.stdout.splitlines():
        if not line.startswith("TUNE_RESULT "):
            print(f"[tune-worker] {line}", flush=True)
    check(p.returncode == 0, f"tuning: the child exited {p.returncode}")
    got = [ln for ln in p.stdout.splitlines() if ln.startswith("TUNE_RESULT ")]
    check(bool(got), "tuning: the child printed no result")
    child = json.loads(got[-1][len("TUNE_RESULT "):])
    arrays = np.load(out)
    for fit, (parent_arrays, _, _) in fits.items():
        t, pt = child["tuning"][fit], res["parent"][fit]
        check(t["sweeps"] == 0 and all(d["decision"] == "hit" for d in t["decisions"])
              and [d["kernel"] for d in t["decisions"]] == TUNE_SWEPT[fit],
              f"tuning child {fit}: decisions {t['decisions']}")
        check([d["geometry"] for d in t["decisions"]] == [d["geometry"] for d in pt["decisions"]],
              f"tuning child {fit}: geometry {t['decisions']} against {pt['decisions']}")
        for j, a in enumerate(parent_arrays):
            check(np.array_equal(arrays[f"{fit}_{j}"], a),
                  f"tuning child {fit}: array {j} not bit-equal to this process's fit")
    swept = {k: v for k, v in child["counters"].items() if "sweeps" in k and v}
    check(not swept, f"tuning child: swept {swept}")
    res["child"] = child["tuning"]
    return res, fits


def _tune_loop(cfg, dev, x, c0, geo):
    """The in-memory fit's K1 Lloyd loop (``kmeans_kernel.lloyd_run_kernel``)
    at a resolved geometry, the counts zeroed just before and read just
    after."""
    kc = cfg["fit_kmeans"]
    _zero_launches()
    c, it, cost, _ = kmeans_kernel.lloyd_run_kernel(
        x, torch.ones(x.shape[0], device=dev), c0, kc["max_iter"], 1e-4, "highest",
        geometry=geo)
    return c, it, cost, _launches()


def tune_pinned_fits(cfg, dev):
    """Leg 3: under a non-default pin of every kernel against the defaults:
    K-Means through the fit's K1 Lloyd loop from centers near the blob
    centers (from data rows two centers can share a blob, and a rounding
    then moves rows between them), the PCA and implicit ALS fits; the
    centers, the PCA ratios and the ALS factors within the fold bound,
    the PCA components within PCA_FIT_TOL (an eigenvector moves by the
    covariance's rounding over its eigen-gap), the ALS solve's pin alone
    bit-equal.  The ALS fit carries K4's fold through its solves (2.3e-6
    on an H100 at two iterations): its bound is also twice its distance
    from the default fit with K4's plain version, which adds the same
    rows in another order.  Every error is printed before any is
    checked."""
    kc = cfg["fit_kmeans"]
    x, c0, xp, ratings = _tune_data(cfg, dev)
    bucket = autotune.shape_bucket(kc["k"], kc["d"])
    fits = {}
    real_gram = als_kernel.factor_gram
    try:
        for tag, spec in (("default", "off"), ("pinned", json_pin(TUNE_PINS)),
                          # K3's pin alone: K4 pinned to its default, not
                          # to leg 2's cached winner
                          ("solve_only", json_pin({"als_solve": TUNE_PINS["als_solve"],
                                                   "als_gram": autotune.DEFAULTS["als_gram"]}))):
            set_config(tuning=spec)
            geo = autotune.resolve("kmeans", bucket, "highest", dev)
            fits[tag] = dict(_tune_fits(cfg, dev, (None, None, xp, ratings), ("pca", "als")),
                             kmeans=(geo, _tune_loop(cfg, dev, x, c0, geo)))
        # the ALS witness: the default fit with K4's plain version, whose
        # Gram adds the same rows in another order
        set_config(tuning="off")
        als_kernel.factor_gram = lambda f, mode="highest", geometry=None: \
            als_kernel.factor_gram_plain(f, mode)
        witness = _tune_fits(cfg, dev, (None, None, xp, ratings), ("als",))["als"][0]
    finally:
        als_kernel.factor_gram = real_gram
        set_config(tuning="auto")
    base, pinned = fits["default"], fits["pinned"]
    (g0, (k0, it0, cost0, kl0)), (g1, (k1, it1, cost1, kl1)) = base["kmeans"], pinned["kmeans"]
    out = {"kmeans": {"geometry": g1, "iterations": [it0, it1], "launches": kl1,
                      "errs": {"centers": _fold_err(k1, k0),
                               "cost": _fold_err(cost1.reshape(1), cost0.reshape(1))}}}
    (p0, _, pl0), (p1, ps1, pl1) = base["pca"], pinned["pca"]
    out["pca"] = {"launches": pl1, "geometry": _summary_tuning(ps1)["decisions"],
                  "errs": {"ratios": _fold_err(torch.as_tensor(p1[1]), torch.as_tensor(p0[1])),
                           "components": sign_err(p1[0], p0[0])}}
    (a0, _, al0), (a1, as1, al1) = base["als"], pinned["als"]
    out["als"] = {"launches": al1, "geometry": _summary_tuning(as1)["decisions"],
                  "errs": {"user": _fold_err(torch.as_tensor(a1[0]), torch.as_tensor(a0[0])),
                           "item": _fold_err(torch.as_tensor(a1[1]), torch.as_tensor(a0[1]))},
                  "solve_only_bit_equal": all(np.array_equal(p, q) for p, q in
                                              zip(fits["solve_only"]["als"][0], a0)),
                  "plain_gram_witness": max(_fold_err(torch.as_tensor(w), torch.as_tensor(a))
                                            for w, a in zip(witness, a0))}
    emit("tuning_pinned", out)
    check(g1 == TUNE_PINS["kmeans"] and g0 == autotune.DEFAULTS["kmeans"],
          f"tuning pinned kmeans: resolved {g1}, default {g0}")
    check(it0 == it1 and kl0 == kl1, f"tuning pinned kmeans: {it1} iterations and launches "
                                     f"{kl1}, default {it0} and {kl0}")
    for fit, launches0, launches1, s1 in (("pca", pl0, pl1, ps1), ("als", al0, al1, as1)):
        check(launches0 == launches1, f"tuning pinned {fit}: launches {launches1}, default "
                                      f"{launches0}")
        geos = {d["kernel"]: d["geometry"] for d in _summary_tuning(s1)["decisions"]}
        check(all(geos[k] == TUNE_PINS[k] for k in TUNE_SWEPT[fit]),
              f"tuning pinned {fit}: resolved {geos}")
    check(out["pca"]["errs"]["components"] <= PCA_FIT_TOL,
          f"tuning pinned pca: components {out['pca']['errs']['components']:.3g} from the default")
    check(out["als"]["solve_only_bit_equal"],
          "tuning pinned als_solve alone: not bit-equal to the default fit")
    for fit in TUNE_FITS:
        worst = max(v for k, v in out[fit]["errs"].items() if k != "components")
        # two ALS iterations carry K4's fold through four solves: the
        # pinned fit may lie as far from the default as twice the default
        # fit's distance from its plain-Gram twin
        bound = (max(TUNE_FOLD_RTOL, 2.0 * out["als"]["plain_gram_witness"]) if fit == "als"
                 else TUNE_FOLD_RTOL)
        check(worst <= bound, f"tuning pinned {fit}: {out[fit]['errs']} from the default fit "
                              f"(bound {bound:.3g})")
    return out


def mp_tuning(cfg, dev, rank, nproc, out):
    """World "a"'s autotuner leg (32): under ``tuning="on"`` a data-parallel
    K-Means across the processes resolves K1 through ``resolve_world``:
    process 0 sweeps into a fresh cache, every process records the same
    geometry.  The JSON-lines sink and the flight recorder are armed, so
    the world's streams are there for the trace merger, and each process
    then serves four traced requests of its rows (their ledgers too)."""
    from oap_mllib_tpu_torch import serving

    tc = (TUNE_TINY if cfg is MP_TINY else TUNE_FULL)["world"]
    cache_dir = os.path.join(out, "tuning_world_cache")
    sink = os.path.join(out, "tuning_world.jsonl")
    for path in ([sink] if rank == 0 else []) + [f"{sink}.rank{rank}"]:
        if os.path.exists(path):
            os.remove(path)
    if rank == 0:
        shutil.rmtree(cache_dir, ignore_errors=True)
    lo, hi = rank * tc["n"] // nproc, (rank + 1) * tc["n"] // nproc
    x, _ = blob_rows(tc["n"], lo, hi, tc["d"], tc["k"], 0, dev)
    set_config(tuning="on", tuning_cache_dir=cache_dir, telemetry_log=sink,
               flight_recorder=4096)
    try:
        _zero_launches()
        m = KMeans(k=tc["k"], max_iter=tc["max_iter"], tol=1e-4, seed=0,
                   init_mode="random").fit(x)
        launches = _launches()
        set_config(serve_trace_sample=1.0)
        rows = x[:256].cpu().numpy()
        h = serving.serve(m)
        with serving.TrafficQueue(h, max_batch_rows=256) as q:
            futs = [q.submit(rows[j * 64:(j + 1) * 64]) for j in range(4)]
            answers = [f.result(timeout=120) for f in futs]
        serving.unserve(m)
    finally:
        set_config(tuning="auto", tuning_cache_dir="", telemetry_log="", flight_recorder=0,
                   serve_trace_sample=0.0)
    check(np.array_equal(np.concatenate([np.asarray(a) for a in answers]), m.predict(rows)),
          "mp_tuning: the served answers differ from predict")
    t = m.summary.tuning
    want = (m.summary.num_iter + 1) * len(resolve_devices()) if dev.type == "cuda" else 0
    check(launches[kmeans_kernel.KERNEL] == want,
          f"mp_tuning: K1 launched {launches[kmeans_kernel.KERNEL]} times, expected {want}")
    v = {"decisions": t["decisions"], "sweeps": t["sweeps"], "hits": t["hits"],
         "launches": launches, "sink": sink, "num_iter": m.summary.num_iter}
    mp_same("mp_tuning geometry", json.dumps([d["geometry"] for d in t["decisions"]]).encode())
    emit("mp_tuning", v)
    return v


def tune_world(world_a):
    """Leg 4: both processes of world "a" resolved K1 once, process 0 by a
    sweep and process 1 as a hit of the geometry process 0 sent."""
    ranks = [r["mp_tuning"] for r in world_a]
    geos = [[d["geometry"] for d in v["decisions"]] for v in ranks]
    check(all(g == geos[0] for g in geos) and len(geos[0]) == 1,
          f"tuning world: the processes resolved {geos}")
    check([d["decision"] for d in ranks[0]["decisions"]] == ["sweep"]
          and all([d["decision"] for d in v["decisions"]] == ["hit"] for v in ranks[1:]),
          f"tuning world: decisions {[v['decisions'] for v in ranks]}")
    return {"processes": len(ranks), "geometry": geos[0],
            "decisions": [v["decisions"][0]["decision"] for v in ranks]}


def tune_merge(paths):
    """Leg 5: the JSON-lines streams through tools/oaptrace.py: a trace
    that validates; its tracks, flows and request lanes."""
    from oap_mllib_tpu_torch.tools import oaptrace

    files = oaptrace.expand_paths(paths)
    trace = oaptrace.merge_trace(files)
    problems = oaptrace.validate_trace(trace)
    check(problems == [], f"tuning merge: {problems[:5]}")
    ev = trace["traceEvents"]
    flows = {}
    for e in ev:
        if e.get("ph") == "s":
            flows[e.get("cat")] = flows.get(e.get("cat"), 0) + 1
    lanes = {(e["pid"], e["tid"]) for e in ev if e.get("cat") == "request"}
    v = {"files": [os.path.basename(f) for f in files], "mode": trace["otherData"]["mode"],
         "tracks": trace["otherData"]["ranks"], "events": len(ev), "flows": flows,
         "request_lanes": len(lanes), "requests": trace["otherData"]["requests"],
         "slices": sum(1 for e in ev if e.get("ph") == "X")}
    check(len(v["tracks"]) >= 2 and v["slices"] > 0 and sum(flows.values()) > 0,
          f"tuning merge: {v}")
    print(f"tuning merge: {len(files)} files, tracks {v['tracks']}, flows {flows}, "
          f"request lanes {v['request_lanes']}, {v['events']} events ({v['mode']} mode)",
          flush=True)
    return v


def phase_tuning(cfg, dev, rehearse, world_a=None, tel_sink=None):
    """Phase 32 (module docstring): the autotuner's five legs, each with
    the launch counts zeroed just before and read just after."""
    t_phase = time.perf_counter()
    reps = cfg["reps"] if dev.type == "cuda" else 1
    res = {}
    _zero_launches()
    res["kmeans"] = tune_kmeans_candidates(cfg, dev, reps)
    res["pca"] = tune_pca_candidates(cfg, dev, reps)
    res["als_solve"], res["als_gram"] = tune_als_candidates(cfg, dev, reps)
    res["ring"], seg2_launches = tune_ring_candidates(cfg, dev, reps)
    res["leg1_launches"] = _launches()
    for kernel in ("kmeans", "pca", "als_solve", "als_gram", "ring"):
        print(f"tuning candidates {kernel}: " + "; ".join(
            f"{v.get('mode', v.get('r', ''))} {v.get('geometry', v.get('segments'))} "
            f"{v['ms']:.4f} ms" for v in res[kernel] if "ms" in v), flush=True)
        emit(f"tuning_{kernel}", res[kernel])
    res["cache"], tuned = tune_cache_contract(cfg, dev, rehearse)
    del tuned
    res["pinned"] = tune_pinned_fits(cfg, dev)
    res["pinned"]["sharded_segments_2_launches"] = seg2_launches
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oap_mllib_tpu_torch",
                       "build", "mp_smoke")
    if world_a is None:
        os.makedirs(out, exist_ok=True)
        flags = (["--rehearse"] if rehearse else []) + ["--tuning-only"]
        world_a, res["world_wall_s"] = run_world("a", 2, out, flags)
    res["world"] = tune_world(world_a)
    emit("tuning_world", res["world"])
    streams = [world_a[0]["mp_tuning"]["sink"]]
    if tel_sink is not None and os.path.exists(tel_sink):
        streams.append(tel_sink)
    else:
        # phase 27 did not run: this process's own fits, armed, stand in
        own = os.path.join(_scratch("tuning_sink"), "tuning.jsonl")
        set_config(telemetry_log=own, flight_recorder=4096, tuning="auto")
        try:
            _tune_fits(cfg, dev, _tune_data(cfg, dev))
        finally:
            set_config(telemetry_log="", flight_recorder=0)
        streams.append(own)
    res["merge"] = tune_merge(streams)
    res["wall_s"] = time.perf_counter() - t_phase
    emit("tuning", {k: res[k] for k in ("world", "merge", "wall_s")})
    return res


# -- 33. ingest: the native host layer -----------------------------------------------
# Phase 33 writes the example formats at their main paths' sizes, reads
# them through the host library and fits from what it read.  The text is
# written by writer processes, a slice each (the formatting is Python's).
INGEST_FULL = {"als": ALS_FULL, "plain_lines": 1 << 20, "prep_blocks": 4,
               "libsvm": (1 << 18, 256), "kmeans_k": 100, "plain_rows": 16_384,
               "csv": (1 << 17, 128), "pca_k": 16}
INGEST_TINY = {"als": ALS_TINY, "plain_lines": 4096, "prep_blocks": 4,
               "libsvm": (3000, 40), "kmeans_k": 6, "plain_rows": 1000,
               "csv": (2000, 24), "pca_k": 4}
INGEST_TIMESTAMP = 978_300_760  # MovieLens ratings.dat's fourth field


# one writer process: ``python -c _TEXT_WRITER kind first_row ts out in.npy ...``
# formats its slice of the arrays (numpy only: no torch import, no fork)
_TEXT_WRITER = r"""
import sys
import numpy as np

kind, first, ts, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
a = [np.load(p) for p in sys.argv[5:]]
n = len(a[0])
with open(out, "w") as f:
    for lo in range(0, n, 1 << 18):
        hi = min(n, lo + (1 << 18))
        if kind == "ratings":
            u, i, r = (x[lo:hi].tolist() for x in a)
            f.write("".join(f"{x}::{y}::{z:.9g}::{ts + k % 86400}\n"
                            for k, x, y, z in zip(range(first + lo, first + hi), u, i, r)))
        elif kind == "libsvm":
            labels, x = a
            for row in range(lo, hi):
                nz = np.flatnonzero(x[row])
                f.write(" ".join([f"{labels[row]:.9g}"] + [
                    f"{j + 1}:{v:.9g}" for j, v in zip(nz.tolist(), x[row, nz].tolist())]) + "\n")
        else:
            f.write("".join(",".join(f"{v:.9g}" for v in row) + "\n"
                            for row in a[0][lo:hi].tolist()))
"""


def ingest_write(path, kind, n, arrays):
    """``n`` rows of ``kind`` text from ``arrays`` (a tuple of row-aligned
    arrays), written by writer processes a slice each and concatenated;
    returns (bytes, seconds)."""
    t0 = time.perf_counter()
    workers = max(1, min(8, len(os.sched_getaffinity(0)), n // 4096))
    cuts = np.linspace(0, n, workers + 1).astype(np.int64).tolist()
    parts, procs, inputs = [], [], []
    try:
        for k in range(workers):
            lo, hi = cuts[k], cuts[k + 1]
            npys = [f"{path}.in{k}.{j}.npy" for j in range(len(arrays))]
            for name, a in zip(npys, arrays):
                np.save(name, a[lo:hi])
            inputs += npys
            parts.append(f"{path}.part{k}")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _TEXT_WRITER, kind, str(lo), str(INGEST_TIMESTAMP),
                 parts[-1], *npys], stderr=subprocess.PIPE, text=True))
        errors = [p.communicate()[1] for p in procs]
        for p, err in zip(procs, errors):
            check(p.returncode == 0, f"ingest: a text writer failed: {err[-2000:]}")
        with open(path, "wb") as out:
            for part in parts:
                with open(part, "rb") as f:
                    shutil.copyfileobj(f, out, 1 << 24)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for name in inputs + parts:
            if os.path.exists(name):
                os.remove(name)
    return os.path.getsize(path), time.perf_counter() - t0


def ingest_head(path, lines):
    """A file of ``path``'s first ``lines`` lines; its path."""
    import itertools

    head = path + ".head"
    with open(path, "rb") as f, open(head, "wb") as out:
        out.writelines(itertools.islice(f, lines))
    return head


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def ingest_ratings(cfg, dev, tmp):
    """(a) MovieLens ratings.dat at ML-25M scale through the host
    parser, the plain reader on its head, and an implicit ALS fit from
    what was read against the fit from the arrays; (b) the shuffle prep
    of the 25M ratings against numpy."""
    from oap_mllib_tpu_torch import native
    from oap_mllib_tpu_torch.data import io as data_io

    als = cfg["als"]
    users, items, ratings = als_data(als)
    path = os.path.join(tmp, "ratings.dat")
    nbytes, write_s = ingest_write(path, "ratings", len(users), (users, items, ratings))
    (pu, pi, pr), parse_s = _timed(data_io.read_ratings, path)
    check(_bits_equal(pu, users.astype(np.int64)) and _bits_equal(pi, items.astype(np.int64))
          and _bits_equal(pr, ratings), "ingest: parsed ratings differ from the source")
    head = ingest_head(path, cfg["plain_lines"])
    (hu, hi, hr), plain_s = _timed(data_io.read_ratings_plain, head)
    m = cfg["plain_lines"]
    check(_bits_equal(hu, pu[:m]) and _bits_equal(hi, pi[:m]) and _bits_equal(hr, pr[:m]),
          "ingest: the plain reader differs from the host parser on the head")
    (gu, gi, gr), head_parse_s = _timed(data_io.read_ratings, head)
    check(_bits_equal(gu, hu) and _bits_equal(gr, hr), "ingest: head parse differs")
    os.remove(path)
    os.remove(head)
    out = {"lines": len(users), "bytes": nbytes, "write_s": write_s, "parse_s": parse_s,
           "parse_mb_s": nbytes / 1e6 / parse_s, "plain_lines": m, "plain_s": plain_s,
           "host_head_s": head_parse_s}

    kw = dict(rank=als["rank"], max_iter=als["max_iter"], reg_param=als["reg"],
              implicit_prefs=True, alpha=als["alpha"], num_user_blocks=1, seed=0,
              device=str(dev))
    n_users, n_items = als["n_users"], als["n_items"]
    fits = {}
    for tag, triples in (("memory", (users, items, ratings)), ("file", (pu, pi, pr))):
        _zero_launches()
        model, wall = _timed(lambda t: ALS(**kw).fit(*t, n_users, n_items), triples)
        fits[tag] = (model, wall, {k: v for k, v in _launches().items() if v})
    (mm, mem_wall, _), (fm, file_wall, launches) = fits["memory"], fits["file"]
    expect = 2 * als["max_iter"] if dev.type == "cuda" else 0
    check(launches.get(als_kernel.SOLVE, 0) == expect
          and launches.get(als_kernel.GRAM, 0) == expect,
          f"ingest ALS launches {launches}, expected {expect} of K3 and K4")
    check(_bits_equal(fm.user_factors_, mm.user_factors_)
          and _bits_equal(fm.item_factors_, mm.item_factors_),
          "ingest: the ALS fit from the file differs from the fit from the arrays")
    out["als"] = {"launches": launches, "fit_from_memory_s": mem_wall,
                  "fit_from_file_s": file_wall, "parse_plus_fit_s": parse_s + file_wall}
    del fits, fm, mm

    nb = cfg["prep_blocks"]
    kpb = -(-n_users // nb)
    got, host_s = _timed(native.shuffle_prep, pu, pi, pr, kpb, nb)

    def plain():
        block = np.minimum(pu // kpb, nb - 1)
        perm = np.lexsort((pi, pu, block))
        return (pu[perm], pi[perm], pr[perm], np.bincount(block, minlength=nb).astype(np.int64),
                perm)

    ref, numpy_s = _timed(plain)
    check(all(_bits_equal(a, b) for a, b in zip(got, ref)),
          "ingest: the host shuffle prep differs from numpy's lexsort")
    block16 = np.minimum(pu // kpb, nb - 1).astype(np.int16)
    _, block_only_s = _timed(lambda: np.argsort(block16, kind="stable"))
    # the prep's two parts: the permutation, and the gather of the three
    # arrays by the library's threads against numpy's a[perm]
    (_, perm), perm_s = _timed(native.shuffle_perm, pu, pi, kpb, nb)
    gathered, gather_s = _timed(lambda: [native.gather(a, perm) for a in (pu, pi, pr)])
    by_numpy, numpy_gather_s = _timed(lambda: [a[perm] for a in (pu, pi, pr)])
    check(all(_bits_equal(a, b) for a, b in zip(gathered, by_numpy)),
          "ingest: the host gather differs from numpy's a[perm]")
    del gathered, by_numpy, perm
    out["shuffle_prep"] = {"records": len(pu), "blocks": nb, "host_s": host_s,
                           "numpy_lexsort_s": numpy_s, "block_only_argsort_s": block_only_s,
                           "perm_s": perm_s, "gather_s": gather_s,
                           "numpy_gather_s": numpy_gather_s}
    return out


def ingest_blobs(n, d, k, seed):
    """The sparse-input phase's table (90 % of a normal table zeroed, its
    first d / 4 columns offset by a cluster id: ~32 % dense), in float64
    rounded to 6 decimals, so ``%.9g`` prints each value exactly."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[rng.random((n, d)) < 0.9] = 0.0
    labels = rng.integers(k, size=n)
    x[:, : d // 4] += labels[:, None]
    x = np.round(x, 6)
    x[x == 0] = 0.0  # no -0.0: a sparse row does not name its zeros
    return labels.astype(np.float64), x


def ingest_libsvm(cfg, dev, tmp):
    """(c) a libsvm file through the host parser and the plain reader,
    and K-Means from it against K-Means from the source array."""
    from oap_mllib_tpu_torch.data import io as data_io

    (n, d), k = cfg["libsvm"], cfg["kmeans_k"]
    labels, x = ingest_blobs(n, d, k, seed=33)
    path = os.path.join(tmp, "blobs.svm")
    nbytes, write_s = ingest_write(path, "libsvm", n, (labels, x))
    (pl, px), parse_s = _timed(data_io.read_libsvm, path, d)
    check(_bits_equal(pl, labels) and _bits_equal(px, x), "ingest: parsed libsvm differs")
    head = ingest_head(path, cfg["plain_rows"])
    (hl, hx), plain_s = _timed(data_io.read_libsvm_plain, head, d)
    m = cfg["plain_rows"]
    check(_bits_equal(hl, pl[:m]) and _bits_equal(hx, px[:m]),
          "ingest: the plain libsvm reader differs from the host parser on the head")
    os.remove(path)
    os.remove(head)
    fits = {}
    for tag, table in (("memory", x), ("file", px)):
        kmeans_kernel.reset_launches()
        model, wall = _timed(lambda t: KMeans(k=k, seed=0, device=str(dev)).fit(t), table)
        fits[tag] = (model, wall, dict(kmeans_kernel.LAUNCHES))
    (mm, mem_wall, _), (fm, file_wall, launches) = fits["memory"], fits["file"]
    expect = fm.summary.num_iter + 1 if dev.type == "cuda" else 0
    check(launches[kmeans_kernel.KERNEL] == expect, f"ingest K-Means launches {launches}")
    check(_bits_equal(fm.cluster_centers_, mm.cluster_centers_),
          "ingest: the K-Means fit from the file differs from the fit from the array")
    return {"shape": [n, d], "density": float(np.count_nonzero(x)) / x.size, "bytes": nbytes,
            "write_s": write_s, "parse_s": parse_s, "parse_mb_s": nbytes / 1e6 / parse_s,
            "plain_rows": m, "plain_s": plain_s, "launches": launches,
            "num_iter": fm.summary.num_iter, "fit_from_memory_s": mem_wall,
            "fit_from_file_s": file_wall}


def ingest_csv(cfg, dev, tmp):
    """(d) a dense CSV through the host parser and PCA from it against
    PCA from the source array."""
    from oap_mllib_tpu_torch.data import io as data_io

    (n, d), k = cfg["csv"], cfg["pca_k"]
    rng = np.random.default_rng(34)
    x = np.round(rng.normal(size=(n, d)) * np.geomspace(10.0, 0.1, d), 6)
    path = os.path.join(tmp, "table.csv")
    nbytes, write_s = ingest_write(path, "csv", n, (x,))
    px, parse_s = _timed(data_io.read_csv, path)
    check(_bits_equal(px, x), "ingest: parsed CSV differs from the source")
    os.remove(path)
    fits = {}
    for tag, table in (("memory", x), ("file", px)):
        pca_kernel.reset_launches()
        model, wall = _timed(lambda t: PCA(k=k, device=str(dev)).fit(t), table)
        fits[tag] = (model, wall, dict(pca_kernel.LAUNCHES))
    (mm, mem_wall, _), (fm, file_wall, launches) = fits["memory"], fits["file"]
    expect = 2 if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == expect, f"ingest PCA launches {launches}")
    check(_bits_equal(fm.components_, mm.components_)
          and _bits_equal(fm.explained_variance_, mm.explained_variance_),
          "ingest: the PCA fit from the file differs from the fit from the array")
    return {"shape": [n, d], "bytes": nbytes, "write_s": write_s, "parse_s": parse_s,
            "parse_mb_s": nbytes / 1e6 / parse_s, "launches": launches,
            "fit_from_memory_s": mem_wall, "fit_from_file_s": file_wall}


def ingest_warmup(dev):
    """A small fit of each estimator, so the kernel libraries' loads and
    first launches fall outside the timed fits."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096, 16)).astype(np.float32)
    KMeans(k=4, max_iter=2, seed=0, device=str(dev)).fit(x)
    PCA(k=2, device=str(dev)).fit(x)
    ALS(rank=4, max_iter=1, implicit_prefs=True, num_user_blocks=1, seed=0,
        device=str(dev)).fit(rng.integers(50, size=2000), rng.integers(40, size=2000),
                             rng.random(2000).astype(np.float32) + 1, 50, 40)


def phase_ingest(cfg, dev, smi):
    """Phase 33 (module docstring): the native host layer on the example
    formats at the main paths' sizes; each fit's counts zeroed just
    before it."""
    from oap_mllib_tpu_torch import native
    from oap_mllib_tpu_torch.parallel import bootstrap

    t_phase = time.perf_counter()
    tables = native.table_count()
    ingest_warmup(dev)
    tmp = tempfile.mkdtemp(prefix="oap_ingest_")
    try:
        res = {"ratings": ingest_ratings(cfg, dev, tmp)}
        emit("ingest_ratings", res["ratings"])
        res["libsvm"] = ingest_libsvm(cfg, dev, tmp)
        emit("ingest_libsvm", res["libsvm"])
        res["csv"] = ingest_csv(cfg, dev, tmp)
        emit("ingest_csv", res["csv"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = bootstrap.free_port("", 3000)
    res["probe"] = {"local_ip": bootstrap.local_ip(), "free_port": port,
                    "native_local_ip": native.local_ip()}
    h = native.table_create(4, 3)
    native.table_append(h, np.ones((5, 3)))
    view_sum = float(torch.from_numpy(native.table_view(h)).sum())
    native.table_free(h)
    res["table_store"] = {"count_before": tables, "count_after": native.table_count(),
                          "view_sum": view_sum}
    check(native.table_count() == tables and view_sum == 15.0,
          f"ingest: table store {res['table_store']}")
    res["wall_s"] = time.perf_counter() - t_phase
    res["card"] = smi
    emit("ingest", {k: res[k] for k in ("probe", "table_store", "wall_s", "card")})
    r, sp = res["ratings"], res["ratings"]["shuffle_prep"]
    print(f"ingest ratings.dat {r['lines']} lines {r['bytes'] / 1e6:.1f} MB: parse "
          f"{r['parse_s']:.3f} s ({r['parse_mb_s']:.0f} MB/s), plain reader "
          f"{r['plain_s']:.3f} s on {r['plain_lines']} lines; prep {sp['host_s']:.3f} s vs "
          f"numpy {sp['numpy_lexsort_s']:.3f} s (gather {sp['gather_s']:.3f} s vs numpy "
          f"{sp['numpy_gather_s']:.3f} s); ALS from file "
          f"{r['als']['fit_from_file_s']:.3f} s vs memory {r['als']['fit_from_memory_s']:.3f} s "
          f"| {smi}", flush=True)
    return res



# -- 34. the float64 parity lane ------------------------------------------------

# phase 34 (x64): K1 at the main path's shape, K2 at the PCA table's, the
# two full-width fits, the streamed, online and mesh routes at 2^18 rows
# (8 chunks), and a short ALS fit
X64_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "pca": (1 << 20, 128),
            "pca_wide": (1 << 18, 1024),
            "pca_k": 16, "small_n": 1 << 18, "chunks": 8, "small_iter": 5,
            "delta_rows": 1 << 16, "als": {"n_users": 20_000, "n_items": 5_000,
                                          "nnz": 400_000, "rank": 10, "max_iter": 3}}
X64_TINY = {"n": 4133, "d": 29, "k": 11, "max_iter": 5, "pca": (3001, 37), "pca_wide": (513, 129),
            "pca_k": 5,
            "small_n": 2048, "chunks": 8, "small_iter": 3, "delta_rows": 1024,
            "als": {"n_users": 300, "n_items": 120, "nnz": 5_000, "rank": 10, "max_iter": 2}}
# H100 SXM data sheet: FP64 on the tensor cores (DMMA) and on the CUDA
# cores; the bound takes the tensor cores' rate, the least time
PEAK_FP64_TC = 67e12
PEAK_FP64 = 34e12
# f64 kernels against their plain versions: the same f64 values summed
# in other orders
X64_RTOL = 1e-12
X64_FIT_TOL = 1e-9
# the card's nvidia-smi line, printed with every phase-34 payload
_SMI = [None]


def blobs64(n, d, k, dev, seed, spread=2.0):
    """:func:`blobs` drawn in float64 on the device."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f64 = torch.float64
    true = torch.randn((k, d), generator=g, device=dev, dtype=f64) * spread
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = true[lab] + torch.randn((n, d), generator=g, device=dev, dtype=f64)
    w = 0.5 + torch.rand((n,), generator=g, device=dev, dtype=f64)
    c = true + 0.5 * torch.randn((k, d), generator=g, device=dev, dtype=f64)
    return x.contiguous(), w, c.contiguous()


def pca_data64(n, d, dev, seed):
    """:func:`pca_data` drawn in float64 on the device."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f64 = torch.float64
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev, dtype=f64))
    scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=f64)
    z = torch.randn((n, d), generator=g, device=dev, dtype=f64) * scale
    return (z @ q.T + 3.0).contiguous()


# ragged shapes of phase 34's small leg: K1 (n, d, k) and K2 (n, d), the
# depths either side of the tiles' edges (16, 128) and an odd one (8-byte
# copies)
X64_SMALL_K1 = ((1000, 1, 3), (3001, 29, 13), (4133, 37, 130), (2000, 128, 257),
                (1025, 129, 64), (777, 300, 70))
X64_SMALL_K2 = ((1000, 1), (3001, 29), (4133, 37), (2000, 128), (1025, 129), (777, 300))


def _x64_small(dev):
    """(a0) both float64 kernels at ragged shapes against their plain
    versions: K1 both modes (labels, sums and counts on the kernel's
    labels, cost, two launches' bits), K2's mean and Gram passes with a
    mask (the Gram bit-symmetric, two launches' bits)."""
    out = {"k1": [], "k2": []}
    for n, d, k in X64_SMALL_K1:
        x, w, c = blobs64(n, d, k, dev, seed=n + d)
        for need_cost in (False, True):
            tag = f"x64 small K1 {n}x{d} k={k} cost={need_cost}"
            sums, counts, cost, labels = run_kernel(x, w, c, "highest", need_cost)
            again = run_kernel(x, w, c, "highest", need_cost)
            check(all((a is None and b is None) or torch.equal(a, b)
                      for a, b in zip((sums, counts, cost, labels), again)),
                  f"{tag}: two launches differ")
            ref_labels, _ = kmeans_kernel.assign_plain(x, c, "highest", need_cost)
            agree = float((labels.long() == ref_labels).float().mean())
            ref_sums, ref_counts = kmeans_kernel.sums_for_labels(x, w, labels, k)
            err_s, err_c = _rel_err(sums, ref_sums), _rel_err(counts, ref_counts)
            v = {"shape": [n, d], "k": k, "need_cost": need_cost, "label_agreement": agree,
                 "sums_rel_err": err_s, "counts_rel_err": err_c}
            if need_cost:
                _, _, ref_cost = kmeans_kernel.lloyd_accumulate_plain(x, w, c, "highest", True)
                v["cost_rel_err"] = abs(float(cost) - float(ref_cost)) / abs(float(ref_cost))
            check(agree >= MIN_AGREEMENT and err_s <= X64_RTOL and err_c <= X64_RTOL
                  and v.get("cost_rel_err", 0.0) <= X64_RTOL, f"{tag}: {v}")
            out["k1"].append(v)
    for n, d in X64_SMALL_K2:
        x = pca_data64(n, d, dev, seed=n + d)
        g = torch.Generator(device="cpu")
        g.manual_seed(n)
        mask = (torch.rand(n, generator=g, dtype=torch.float64) > 0.2).to(dev, torch.float64)
        k, plain = pca_kernel.pca_moments, pca_kernel.pca_moments_plain
        _, cs, cnt = k(x, mask, None, "highest", need_gram=False)
        _, cs_p, cnt_p = plain(x, mask, None, "highest", need_gram=False)
        mean = cs / cnt
        gram, _, _ = k(x, mask, mean, "highest", need_sums=False)
        again, _, _ = k(x, mask, mean, "highest", need_sums=False)
        ref, _, _ = plain(x, mask, mean, "highest", need_sums=False)
        v = {"shape": [n, d], "colsum_rel_err": _rel_err(cs, cs_p),
             "count_err": abs(float(cnt) - float(cnt_p)), "gram_rel_err": _rel_err(gram, ref)}
        check(torch.equal(gram, again) and (dev.type != "cuda" or torch.equal(gram, gram.T))
              and v["colsum_rel_err"] <= X64_RTOL and v["count_err"] == 0.0
              and v["gram_rel_err"] <= X64_RTOL, f"x64 small K2 {n}x{d}: {v}")
        out["k2"].append(v)
    emit("x64_small", {**out, "card": _SMI[0]})
    return out


def _x64_split(fn, dev):
    """Device ms by kernel of one call of ``fn`` (torch.profiler over three
    calls, each kernel's mean over the launches recorded: the tracer can
    drop one) and their sum; None where the profiler records no device
    time."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        sync(dev)
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        m = re.search(r"(\w+_kernel)(<[^>]*>)?|Memset", ev.key)
        if us and m:
            by[m.group(0)] = by.get(m.group(0), 0.0) + us / max(1, ev.count) / 1e3
    return {"kernels_ms": by, "device_ms": sum(by.values())} if by else None


def ptxas_by_function(names, part):
    """Registers, shared bytes and spills that ``-Xptxas -v`` reported for
    the kernels of the libraries ``names`` whose mangled names hold
    ``part``."""
    out = {}
    for name in names:
        log = _build.build_dir() / f"{name}.ptxas.log"
        if not log.exists():
            continue
        fn = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if part in m.group(1) else None
                continue
            if fn is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(fn, {}).update(spill_stores=int(m.group(1)),
                                              spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out.setdefault(fn, {}).update(registers=int(m.group(1)),
                                              static_smem=int(smem.group(1)) if smem else 0)
    return out


def _x64_ptxas():
    """ptxas's figures for the float64 forms' kernels (their mangled
    names hold ``dmma``)."""
    out = ptxas_by_function((kmeans_kernel.KERNEL, pca_kernel.KERNEL), "dmma")
    for fn, v in out.items():
        print(f"ptxas x64 {fn}: {v}", flush=True)
    return out


def gram_highest_build(lib):
    """The highest tier's tensor-core Gram instances in the built
    library (``gram_wgmma_kernel<0, VEC>``, mangled ``...ILi0E...``): each
    holds HGMMA instructions in its SASS, and ptxas reports each with no
    spill; fails otherwise."""
    part = "gram_wgmma_kernelILi0E"
    hgmma = {f: v for f, v in count_sass_by_function(lib, "HGMMA").items() if part in f}
    ptxas = ptxas_by_function((pca_kernel.KERNEL,), part)
    out = {f: {"hgmma": hgmma.get(f), **ptxas.get(f, {})} for f in sorted({*hgmma, *ptxas})}
    print(f"sass/ptxas {lib.name} highest Gram: {out}", flush=True)
    check(hgmma and all(v > 0 for v in hgmma.values()),
          f"a highest-tier Gram instance holds no HGMMA instruction: {hgmma}")
    check(ptxas.keys() == hgmma.keys()
          and all(v.get("spill_stores") == 0 and v.get("spill_loads") == 0
                  for v in ptxas.values()),
          f"highest-tier Gram instances: ptxas reports a spill or none: {out}")
    return out


def _x64_k1(x, w, c, dev, reps):
    """(a) K1's float64 form against its plain version on the card, both
    modes: labels, sums and counts on the kernel's labels, cost, two
    launches' bits; ms, bound, plain and library times."""
    n, d = x.shape
    k = c.shape[0]
    out = []
    for need_cost in (False, True):
        tag = f"x64 K1 cost={need_cost}"
        sums, counts, cost, labels = run_kernel(x, w, c, "highest", need_cost)
        again = run_kernel(x, w, c, "highest", need_cost)
        same = all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip((sums, counts, cost, labels), again))
        check(same, f"{tag}: two launches differ")
        check(sums.dtype == torch.float64 and counts.dtype == torch.float64,
              f"{tag}: outputs {sums.dtype}, {counts.dtype}")
        ref_labels, _ = kmeans_kernel.assign_plain(x, c, "highest", need_cost)
        agree = float((labels.long() == ref_labels).float().mean())
        check(agree >= MIN_AGREEMENT, f"{tag}: labels agree on {agree:.6f} of rows")
        ref_sums, ref_counts = kmeans_kernel.sums_for_labels(x, w, labels, k)
        err_s, err_c = _rel_err(sums, ref_sums), _rel_err(counts, ref_counts)
        check(err_s <= X64_RTOL and err_c <= X64_RTOL,
              f"{tag}: sums rel err {err_s:.3g}, counts {err_c:.3g}")
        v = {"need_cost": need_cost, "shape": [n, d], "k": k, "label_agreement": agree,
             "sums_rel_err": err_s, "counts_rel_err": err_c, "deterministic": same,
             "max_abs_err": float(torch.max(torch.abs(sums - ref_sums)))}
        if need_cost:
            _, _, ref_cost = kmeans_kernel.lloyd_accumulate_plain(x, w, c, "highest", True)
            v["cost_rel_err"] = abs(float(cost) - float(ref_cost)) / abs(float(ref_cost))
            check(v["cost_rel_err"] <= X64_RTOL, f"{tag}: cost rel err {v['cost_rel_err']:.3g}")
        v["ms"] = time_ms(lambda: run_kernel(x, w, c, "highest", need_cost), dev, reps)
        v["plain_ms"] = time_ms(
            lambda: kmeans_kernel.lloyd_accumulate_plain(x, w, c, "highest", need_cost),
            dev, max(1, reps // 4))
        ops = 2.0 * n * k * d + 2.0 * n * d
        nbytes = 8.0 * (n * d + n + 2 * k * d)
        v["bound_ms"], v["bound_by"] = _bound(ops / PEAK_FP64_TC, nbytes / PEAK_BYTES)
        v["fp64_pipe_ms"] = ops / PEAK_FP64 * 1e3
        v["library_ms"] = time_ms(lambda: torch.matmul(x, c.T), dev, reps)
        v["library_call"] = "torch.matmul(x, c.T) in float64: the cross product only"
        # the assignment's device time beside the whole pass's
        split = _x64_split(lambda: run_kernel(x, w, c, "highest", need_cost), dev)
        v["split"] = split
        v["assign_ms"] = (None if split is None else
                          sum(t for name, t in split["kernels_ms"].items() if "assign" in name))
        emit("x64_k1", {**v, "card": _SMI[0]})
        out.append(v)
    return out


def _x64_k2(x, dev, reps):
    """(b) K2's float64 form against its plain version on the card: the
    mean pass and the Gram pass."""
    n, d = x.shape
    mask = torch.ones(n, dtype=torch.float64, device=dev)
    k, plain = pca_kernel.pca_moments, pca_kernel.pca_moments_plain
    _, cs, cnt = k(x, mask, None, "highest", need_gram=False)
    _, cs_p, cnt_p = plain(x, mask, None, "highest", need_gram=False)
    mean = cs / float(n)
    g, _, _ = k(x, mask, mean, "highest", need_sums=False)
    g2, _, _ = k(x, mask, mean, "highest", need_sums=False)
    g_p, _, _ = plain(x, mask, mean, "highest", need_sums=False)
    check(g.dtype == cs.dtype == torch.float64, f"x64 K2: outputs {g.dtype}, {cs.dtype}")
    check(torch.equal(g, g2), "x64 K2 Gram pass: two launches differ")
    check(dev.type != "cuda" or torch.equal(g, g.T), "x64 K2 Gram pass: not bit-symmetric")
    v = {"shape": [n, d], "colsum_rel_err": _rel_err(cs, cs_p),
         "count_err": abs(float(cnt) - float(cnt_p)), "gram_rel_err": _rel_err(g, g_p),
         "max_abs_err": float(torch.max(torch.abs(g - g_p))), "deterministic": True}
    check(v["colsum_rel_err"] <= X64_RTOL and v["count_err"] == 0.0
          and v["gram_rel_err"] <= X64_RTOL,
          f"x64 K2: colsum {v['colsum_rel_err']:.3g}, count {v['count_err']}, "
          f"Gram {v['gram_rel_err']:.3g}")
    v["mean_ms"] = time_ms(lambda: k(x, mask, None, "highest", need_gram=False), dev, reps)
    v["ms"] = time_ms(lambda: k(x, mask, mean, "highest", need_sums=False), dev, reps)
    v["plain_ms"] = time_ms(lambda: plain(x, mask, mean, "highest", need_sums=False), dev, reps)
    ops = float(n) * d * (d + 1)
    nbytes = 8.0 * (n * d + n + d + d * d)
    v["bound_ms"], v["bound_by"] = _bound(ops / PEAK_FP64_TC, nbytes / PEAK_BYTES)
    v["fp64_pipe_ms"] = ops / PEAK_FP64 * 1e3
    xc = x - mean
    v["library_ms"] = time_ms(lambda: torch.matmul(xc.T, xc), dev, reps)
    v["library_call"] = "torch.matmul(xc.T, xc) in float64"
    split = _x64_split(lambda: k(x, mask, mean, "highest", need_sums=False), dev)
    v["split"] = split
    v["gram_ms"] = (None if split is None else
                    sum(t for name, t in split["kernels_ms"].items() if "gram_dmma" in name))
    emit("x64_k2", {**v, "card": _SMI[0]})
    return v


def _plain_k1(x, w, c, mode="highest", need_cost=True, geometry=None):
    return kmeans_kernel.lloyd_accumulate_plain(x, w, c, mode, need_cost)


def _x64_kmeans_fit(cfg, dev):
    """(c) the full-width f64 K-Means fit, counts zeroed just before: K1's
    float64 form num_iter + 1 times, the centers within 1e-9 of the same
    fit through the plain version with equal iterations; its distance
    from the f32 fit of the same rows."""
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    x, _, _ = blobs64(n, d, k, dev, seed=34)

    def fit():
        return KMeans(k=k, max_iter=it, tol=1e-4, seed=0, device=str(dev)).fit(x)

    sync(dev)
    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    model, launches = counted_fit(fit, kmeans_kernel.LAUNCHES)
    wall = time.perf_counter() - t0
    f64_launches = kmeans_kernel.LAUNCHES_BY_DTYPE["float64"]
    s = model.summary
    expect = s.num_iter + 1 if dev.type == "cuda" else 0
    check(model.cluster_centers_.dtype == np.float64, "x64 fit: centers not float64")
    check(launches[kmeans_kernel.KERNEL] == expect == f64_launches,
          f"x64 fit: K1 launched {launches[kmeans_kernel.KERNEL]} times "
          f"({f64_launches} float64), expected num_iter + 1 = {expect}")
    # 8 bytes an element: the planner must still keep the table resident
    check(s.route["route"] in ("in-memory", "chunked") and not s.streamed,
          f"x64 fit: route {s.route['route']}")
    real = kmeans_kernel.lloyd_accumulate
    kmeans_kernel.lloyd_accumulate = _plain_k1
    try:
        ref = fit()
    finally:
        kmeans_kernel.lloyd_accumulate = real
    err = float(np.max(np.abs(model.cluster_centers_ - ref.cluster_centers_)))
    check(s.num_iter == ref.summary.num_iter and err <= X64_FIT_TOL,
          f"x64 fit vs the plain-version fit: {s.num_iter} vs {ref.summary.num_iter} "
          f"iterations, centers {err:.3g}")
    set_config(enable_x64=False)
    try:
        t0 = time.perf_counter()
        f32 = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, device=str(dev)).fit(x.float())
        wall32 = time.perf_counter() - t0
    finally:
        set_config(enable_x64=True)
    out = {"shape": [n, d], "k": k, "num_iter": s.num_iter, "wall_s": wall,
           "phases_s": s.timings.as_dict(), "launches": launches,
           "launches_float64": f64_launches, "route": s.route["route"],
           "vs_plain_centers_max_abs": err, "training_cost": s.training_cost,
           "f32_wall_s": wall32, "f32_num_iter": f32.summary.num_iter,
           "vs_f32_centers_max_abs": float(np.max(np.abs(
               model.cluster_centers_ - f32.cluster_centers_))),
           "tuning": [dd["decision"] for dd in s.tuning["decisions"]]}
    emit("x64_kmeans_fit", {**out, "card": _SMI[0]})
    return out


def _x64_pca_fit(cfg, dev):
    """(c) the full-width f64 PCA fit, counts zeroed just before: K2's
    float64 form twice; the components within 1e-9 (sign-insensitive) of
    a float64 numpy eigh of the host covariance."""
    (n, d), k = cfg["pca"], cfg["pca_k"]
    x = pca_data64(n, d, dev, seed=d)
    sync(dev)
    pca_kernel.reset_launches()
    t0 = time.perf_counter()
    model, launches = counted_fit(lambda: PCA(k=k, device=str(dev)).fit(x),
                                  pca_kernel.LAUNCHES)
    wall = time.perf_counter() - t0
    expect = 2 if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == expect == pca_kernel.LAUNCHES_BY_DTYPE["float64"],
          f"x64 PCA fit: K2 launched {launches[pca_kernel.KERNEL]} times, expected {expect}")
    check(model.components_.dtype == model.explained_variance_.dtype == np.float64,
          "x64 PCA fit: outputs not float64")
    host = x.cpu().numpy()
    xc = host - host.mean(axis=0)
    vals, vecs = np.linalg.eigh(xc.T @ xc / (n - 1))
    vals, vecs = vals[::-1], vecs[:, ::-1]
    comp_err = sign_err(model.components_, vecs[:, :k])
    ratio_err = float(np.max(np.abs(model.explained_variance_ - vals[:k] / vals.sum())))
    check(comp_err <= X64_FIT_TOL and ratio_err <= 1e-12,
          f"x64 PCA fit vs numpy f64 eigh: components {comp_err:.3g}, ratios {ratio_err:.3g}")
    set_config(enable_x64=False)
    try:
        t0 = time.perf_counter()
        f32 = PCA(k=k, device=str(dev)).fit(x.float())
        wall32 = time.perf_counter() - t0
    finally:
        set_config(enable_x64=True)
    out = {"shape": [n, d], "k": k, "wall_s": wall, "launches": launches,
           "components_err_vs_numpy": comp_err, "ratio_err_vs_numpy": ratio_err,
           "f32_wall_s": wall32,
           "vs_f32_components": sign_err(model.components_, f32.components_.astype(np.float64)),
           "route": model.summary["route"]["route"]}
    emit("x64_pca_fit", {**out, "card": _SMI[0]})
    return out


def _x64_routes(cfg, dev):
    """(d) the streamed, online and mesh routes at ``small_n`` rows."""
    n, d, k, it, chunks = cfg["small_n"], cfg["d"], cfg["k"], cfg["small_iter"], cfg["chunks"]
    rows = n // chunks
    x, _, c0 = blobs64(n, d, k, dev, seed=35)
    host = x.cpu().numpy()
    out = {}
    # the streamed Lloyd loop against the in-memory kernel loop from the
    # same centers, then the streamed estimator fits
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0, it, 1e-4)
    src = ChunkSource.from_array(host, chunk_rows=rows)
    kmeans_kernel.reset_launches()
    c2, it2, cost2, _ = stream_ops.lloyd_run_streamed(src, c0, it, 1e-4, device=dev)
    loop_launches = kmeans_kernel.LAUNCHES_BY_DTYPE["float64"]
    err = float(torch.max(torch.abs(c2 - c1)))
    check(c2.dtype == torch.float64 and it1 == it2 and err <= X64_FIT_TOL
          and abs(float(cost2) - float(cost1)) <= X64_RTOL * float(cost1),
          f"x64 streamed loop: {it2} vs {it1} iterations, centers {err:.3g}")
    check(loop_launches == (chunks * (it2 + 1) if dev.type == "cuda" else 0),
          f"x64 streamed loop: K1 launched {loop_launches} times")
    out["stream_loop"] = {"n_iter": it2, "centers_max_abs": err, "launches": loop_launches}
    km, launches = counted_fit(
        lambda: KMeans(k=k, max_iter=it, seed=0, init_mode="random", device=str(dev)).fit(src),
        kmeans_kernel.LAUNCHES)
    check(km.cluster_centers_.dtype == np.float64 and km.summary.streamed,
          "x64 streamed K-Means: not a float64 streamed fit")
    out["stream_kmeans"] = {"n_iter": km.summary.num_iter, "launches": launches}
    pca_x = pca_data64(n, cfg["pca"][1], dev, seed=36)
    pca_host = pca_x.cpu().numpy()
    mem = PCA(k=cfg["pca_k"], device=str(dev)).fit(pca_x)
    pm, launches = counted_fit(
        lambda: PCA(k=cfg["pca_k"], device=str(dev)).fit(
            ChunkSource.from_array(pca_host, chunk_rows=rows)), pca_kernel.LAUNCHES)
    comp_err = sign_err(pm.components_, mem.components_)
    check(pm.components_.dtype == np.float64 and comp_err <= X64_FIT_TOL
          and launches[pca_kernel.KERNEL] == (2 * chunks if dev.type == "cuda" else 0),
          f"x64 streamed PCA: components {comp_err:.3g}, launches {launches}")
    out["stream_pca"] = {"components_err": comp_err, "launches": launches}
    # partial_fit: the kernel's fold against the plain version's on the
    # CPU, from the same centers and counts
    delta = host[: cfg["delta_rows"]]
    models = []
    for where in (str(dev), "cpu"):
        m = KMeansModel(c0.cpu().numpy(), device=where)
        m._online_counts = np.full(k, 100.0)
        models.append(m)
    kmeans_kernel.reset_launches()
    models[0].partial_fit(ChunkSource.from_array(delta, chunk_rows=delta.shape[0] // 4))
    pf_launches = dict(kmeans_kernel.LAUNCHES)
    models[1].partial_fit(ChunkSource.from_array(delta, chunk_rows=delta.shape[0] // 4))
    err = float(np.max(np.abs(models[0].cluster_centers_ - models[1].cluster_centers_)))
    check(models[0].cluster_centers_.dtype == np.float64 and err <= X64_FIT_TOL
          and pf_launches[kmeans_kernel.KERNEL] == (4 if dev.type == "cuda" else 0),
          f"x64 partial_fit: centers {err:.3g} from the CPU fold, launches {pf_launches}")
    out["partial_fit"] = {"centers_max_abs": err, "launches": pf_launches}
    # IncrementalPCA: the raw moments against numpy's, the commit against
    # the batch f64 fit
    ipca = IncrementalPCA(cfg["pca_k"], device=str(dev))
    pca_kernel.reset_launches()
    for lo in range(0, n, n // 4):
        ipca.partial_fit(pca_host[lo:lo + n // 4])
    ip_launches = dict(pca_kernel.LAUNCHES)
    gram_err = (np.max(np.abs(ipca._gram - pca_host.T @ pca_host))
                / np.max(np.abs(ipca._gram)))
    comp_err = sign_err(ipca.commit().components_, mem.components_)
    check(ipca._gram.dtype == np.float64 and gram_err <= X64_RTOL and comp_err <= X64_FIT_TOL
          and ip_launches[pca_kernel.KERNEL] == (4 if dev.type == "cuda" else 0),
          f"x64 IncrementalPCA: moments {gram_err:.3g}, components {comp_err:.3g}, "
          f"launches {ip_launches}")
    out["incremental_pca"] = {"gram_rel_err": float(gram_err), "components_err": comp_err,
                              "launches": ip_launches}
    # the mesh: data-parallel (4, 1) and model-sharded (2, 2) f64 fits
    # against the one-card fit from the same random rows; the ring packs
    # f32, so K5 launches 0 times
    one = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, init_mode="random",
                 device=str(dev)).fit(x)
    for mp in (1, 2):
        devs = mesh_devices(dev, 4)
        set_config(model_parallel=mp)
        try:
            mesh_m, launches = counted_fit(
                lambda: KMeans(k=k, max_iter=it, tol=1e-4, seed=0, init_mode="random",
                               device=",".join(str(q) for q in devs)).fit(x),
                kmeans_kernel.LAUNCHES, ring_kernel.LAUNCHES)
        finally:
            set_config(model_parallel=1)
        err = float(np.max(np.abs(mesh_m.cluster_centers_ - one.cluster_centers_)))
        s = mesh_m.summary
        want_k1 = (s.num_iter + 1) * 4 if (mp == 1 and dev.type == "cuda") else 0
        check(launches[ring_kernel.KERNEL] == 0 and s.ring is False
              and launches[kmeans_kernel.KERNEL] == want_k1,
              f"x64 mesh ({4 // mp}, {mp}): launches {launches}, ring {s.ring}")
        check(mesh_m.cluster_centers_.dtype == np.float64 and s.num_iter == one.summary.num_iter
              and err <= X64_FIT_TOL,
              f"x64 mesh ({4 // mp}, {mp}): {s.num_iter} vs {one.summary.num_iter} "
              f"iterations, centers {err:.3g}")
        out[f"mesh_{4 // mp}x{mp}"] = {"devices": [str(q) for q in devs], "launches": launches,
                                       "centers_max_abs": err, "num_iter": s.num_iter}
    emit("x64_routes", {**out, "card": _SMI[0]})
    return out


def _x64_als(cfg, dev):
    """(e) a short implicit ALS fit with the flag on and off: K3 and K4
    launch as before and the factors are bit-equal (ALS reads no x64)."""
    u, i, r = als_data(cfg)
    kw = dict(rank=cfg["rank"], max_iter=cfg["max_iter"], implicit_prefs=True, alpha=40.0,
              reg_param=0.1, seed=0, device=str(dev))
    on, launches_on = counted_fit(lambda: ALS(**kw).fit(u, i, r), als_kernel.LAUNCHES)
    set_config(enable_x64=False)
    try:
        off, launches_off = counted_fit(lambda: ALS(**kw).fit(u, i, r), als_kernel.LAUNCHES)
    finally:
        set_config(enable_x64=True)
    want = 2 * cfg["max_iter"] if dev.type == "cuda" else 0
    same = (on.user_factors_.tobytes() == off.user_factors_.tobytes()
            and on.item_factors_.tobytes() == off.item_factors_.tobytes())
    check(same and launches_on == launches_off
          and launches_on[als_kernel.SOLVE] == launches_on[als_kernel.GRAM] == want
          and on.user_factors_.dtype == np.float32,
          f"x64 ALS: bit-equal {same}, launches {launches_on} vs {launches_off}")
    out = {"launches": launches_on, "bit_equal": same}
    emit("x64_als", {**out, "card": _SMI[0]})
    return out


def phase_x64(cfg, dev, smi):
    """Phase 34 (module docstring): the float64 parity lane under
    ``enable_x64=True``, launch counts zeroed before each fit."""
    t_phase = time.perf_counter()
    reps = 10 if dev.type == "cuda" else 1
    _SMI[0] = smi
    set_config(enable_x64=True)
    try:
        ptxas = _x64_ptxas() if dev.type == "cuda" else {}
        small = _x64_small(dev)
        x, w, c = blobs64(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)
        k1 = _x64_k1(x, w, c, dev, reps)
        del x, w, c
        k2 = _x64_k2(pca_data64(*cfg["pca"], dev, seed=cfg["pca"][1]), dev, reps)
        k2_wide = _x64_k2(pca_data64(*cfg["pca_wide"], dev, seed=cfg["pca_wide"][1]), dev,
                          max(1, reps // 2))
        km = _x64_kmeans_fit(cfg, dev)
        pca = _x64_pca_fit(cfg, dev)
        routes = _x64_routes(cfg, dev)
        als = _x64_als(cfg["als"], dev)
    finally:
        set_config(enable_x64=False)
    res = {"k1": k1, "k2": k2, "k2_wide": k2_wide, "small": small, "ptxas": ptxas,
           "kmeans_fit": km, "pca_fit": pca, "routes": routes, "als": als,
           "wall_s": time.perf_counter() - t_phase, "card": smi}
    main = k1[0]

    def ms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    print(f"x64 K1 f64 {main['ms']:.3f} ms a loop pass, its assignment {ms(main['assign_ms'])} "
          f"(bound {main['bound_ms']:.3f} ms by "
          f"{main['bound_by']}, FP64 pipe {main['fp64_pipe_ms']:.3f} ms, plain "
          f"{main['plain_ms']:.3f} ms, torch.matmul f64 {main['library_ms']:.3f} ms); cost pass "
          f"{k1[1]['ms']:.3f} ms, its assignment {ms(k1[1]['assign_ms'])}; K2 f64 Gram "
          f"{k2['ms']:.3f} ms (bound {k2['bound_ms']:.3f} ms by {k2['bound_by']}, plain "
          f"{k2['plain_ms']:.3f} ms, torch.matmul f64 {k2['library_ms']:.3f} ms), at "
          f"{k2_wide['shape'][0]} x {k2_wide['shape'][1]} {k2_wide['ms']:.3f} ms (bound "
          f"{k2_wide['bound_ms']:.3f} ms, torch.matmul f64 {k2_wide['library_ms']:.3f} ms); "
          f"K-Means fit "
          f"{km['wall_s']:.3f} s ({km['num_iter']} iterations, K1 {km['launches_float64']}; "
          f"f32 {km['f32_wall_s']:.3f} s, centers {km['vs_f32_centers_max_abs']:.3g} apart); "
          f"PCA fit {pca['wall_s']:.3f} s (K2 {pca['launches'][pca_kernel.KERNEL]}; f32 "
          f"{pca['f32_wall_s']:.3f} s); phase {res['wall_s']:.1f} s | {smi}", flush=True)
    emit("x64", {k: res[k] for k in ("wall_s", "card")})
    return res


def phase_build(dev):
    """Every kernel built from the sources; ptxas's registers and spills;
    the HGMMA (tensor-core wgmma) instructions of the libraries that must
    hold them.  Returns the nvidia-smi line."""
    smi = nvidia_smi()
    print(f"device {torch.cuda.get_device_name(dev)} | {smi}", flush=True)
    t0 = time.perf_counter()
    paths = _build.build_all()
    emit("build", {"seconds": time.perf_counter() - t0,
                   "sources_hash": _build.sources_hash(), "cwd": os.getcwd(),
                   "libraries": {k: str(v) for k, v in paths.items()}})
    for name in paths:
        log = (_build.build_dir() / f"{name}.ptxas.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
    for name, what in ((pca_kernel.KERNEL, "the Gram at every tier for d >= 64"),
                       (kmeans_kernel.KERNEL, "the Lloyd assignment, every tier")):
        hgmma = count_sass(paths[name], "HGMMA")
        print(f"sass {paths[name].name}: {hgmma} HGMMA instructions "
              f"({what} on the tensor cores)", flush=True)
        check(hgmma > 0, f"the {name} library holds no HGMMA instruction")
    gram_highest_build(paths[pca_kernel.KERNEL])
    return smi


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mp-worker"]:
        return mp_worker(argv[1:])
    if argv[:1] == ["--ckpt-worker"]:
        return ckpt_worker(argv[1:])
    if argv[:1] == ["--tel-worker"]:
        return tel_worker(argv[1:])
    if argv[:1] == ["--sup-worker"]:
        return sup_worker(argv[1:])
    if argv[:1] == ["--ha-worker"]:
        return ha_worker(argv[1:])
    if argv[:1] == ["--sweep-worker"]:
        return sweep_worker(argv[1:])
    if argv[:1] == ["--tune-worker"]:
        return tune_worker(argv[1:])
    if argv[:1] == ["--k4-worker"]:
        return k4_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at a tiny size, plain versions only")
    ap.add_argument("--mesh", action="store_true",
                    help="only the phases whose ranks span cards (K1-K4 on the last card, "
                         "the ring kernels, the sharded, data-parallel, PCA-mesh, block-ALS "
                         "and 2-D ALS fits, the worlds of processes); prints no ok line")
    ap.add_argument("--block-stream", action="store_true",
                    help="only the build and the streamed block ALS phase (on four cards "
                         "when the machine has four); prints no ok line")
    ap.add_argument("--mp", action="store_true",
                    help="only the build and the phases across processes (the worlds of "
                         "--mesh with it); prints no ok line")
    ap.add_argument("--telemetry", action="store_true",
                    help="only the build and the observability phase (27); prints no ok line")
    ap.add_argument("--online", action="store_true",
                    help="only the build and the serving and online phase (28); prints no "
                         "ok line")
    ap.add_argument("--traffic", action="store_true",
                    help="only the build and the serving front's phase (29); prints no ok "
                         "line")
    ap.add_argument("--front", action="store_true",
                    help="only the build, the factor-sharded serving (30) and the front "
                         "doors (31); prints no ok line")
    ap.add_argument("--ingest", action="store_true",
                    help="only the build and the native host layer's phase (33); prints no "
                         "ok line")
    ap.add_argument("--x64", action="store_true",
                    help="only the build and the float64 parity lane's phase (34); prints no "
                         "ok line")
    ap.add_argument("--wide", action="store_true",
                    help="only the build and K1 above d = 256 (35); prints no ok line")
    ap.add_argument("--tuning", action="store_true",
                    help="only the build and the kernel-geometry autotuner's phase (32; its "
                         "world \"a\" runs alone, and this process's armed fits stand in "
                         "for phase 27's streams); prints no ok line")
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cpu" if args.rehearse else "cuda")
        cfg = TINY if args.rehearse else FULL
        smi = phase_build(dev) if dev.type == "cuda" else None
        if args.telemetry:
            phase_telemetry(TEL_TINY if args.rehearse else TEL_FULL, dev)
            print(f"telemetry phase passed: {smi}", flush=True)
            return 0
        if args.online:
            phase_serve_online(SERVE_TINY if args.rehearse else SERVE_FULL,
                               ALS_TINY if args.rehearse else ALS_FULL, dev)
            print(f"serve_online phase passed: {smi}", flush=True)
            return 0
        if args.traffic:
            phase_serve_traffic(TRAFFIC_TINY if args.rehearse else TRAFFIC_FULL, dev,
                                rehearse=args.rehearse)
            print(f"serve_traffic phase passed: {smi}", flush=True)
            return 0
        if args.front:
            als_cfg = ALS_TINY if args.rehearse else ALS_FULL
            data = als_data(als_cfg)
            sharded, two_d = phase_serve_sharded(als_cfg, data, dev, args.rehearse)
            phase_front_doors(FRONT_TINY if args.rehearse else FRONT_FULL, als_cfg, data, dev,
                              two_d, sharded["two_d"]["fit_launches"])
            print(f"serve_sharded and front_doors phases passed: {smi}", flush=True)
            return 0
        if args.ingest:
            phase_ingest(INGEST_TINY if args.rehearse else INGEST_FULL, dev, smi)
            print(f"ingest phase passed: {smi}", flush=True)
            return 0
        if args.x64:
            phase_x64(X64_TINY if args.rehearse else X64_FULL, dev, smi)
            print(f"x64 phase passed: {smi}", flush=True)
            return 0
        if args.wide:
            phase_kmeans_wide(WIDE_TINY if args.rehearse else WIDE_FULL, dev, smi)
            print(f"kmeans_wide phase passed: {smi}", flush=True)
            return 0
        if args.tuning:
            phase_tuning(TUNE_TINY if args.rehearse else TUNE_FULL, dev, args.rehearse)
            print(f"tuning phase passed: {smi}", flush=True)
            return 0
        if args.block_stream:
            als_cfg = ALS_TINY if args.rehearse else ALS_FULL
            phase_block_stream(als_cfg, als_data(als_cfg), dev)
            print(f"block_stream passed: {smi}", flush=True)
            return 0
        if args.mp:
            mp = phase_mp(dev, args.mesh, args.rehearse)
            emit("mp_launches", mp_launches(mp))
            phase_supervise(dev, args.mesh, args.rehearse)
            print(f"mp phases passed: {smi}", flush=True)
            return 0
        if args.mesh:
            phase_last_card(dev)
            phase_ring_kernels(RING_TINY if args.rehearse else RING_FULL, dev,
                               10 if dev.type == "cuda" else 1)
            phase_sharded_fit(SHARDED_TINY if args.rehearse else SHARDED_FULL, dev)
            phase_dp_fit(DP_TINY if args.rehearse else DP_FULL, dev)
            phase_pca_mesh_fit(PCA_TINY if args.rehearse else PCA_FULL, dev)
            als_cfg = ALS_TINY if args.rehearse else ALS_FULL
            als_data_ = als_data(als_cfg)
            _, rep_model = phase_als_block_fit(als_cfg, als_data_, dev, None)
            _, two_d_model = phase_als_block_2d(als_cfg, als_data_, dev)
            phase_serve_sharded(als_cfg, als_data_, dev, args.rehearse, rep_model, two_d_model)
            del rep_model, two_d_model
            phase_block_stream(als_cfg, als_data_, dev)
            del als_data_
            mp = phase_mp(dev, True, args.rehearse)
            emit("mp_launches", mp_launches(mp))
            phase_supervise(dev, True, args.rehearse)
            print(f"mesh phases passed on {torch.cuda.device_count() if dev.type == 'cuda' else 0}"
                  f" cards: {smi}", flush=True)
            return 0
        phase_small(dev)
        phase_small_slices(dev)
        ladder = phase_ladder(LADDER_TINY if args.rehearse else LADDER_FULL, dev)
        # in a child process (its profiler sessions and this process's
        # must not meet), after the ladder, whose real-OOM leg sizes a
        # memory cap from a clean card
        telemetry = phase_telemetry_child(dev, args.rehearse)
        x, w, c = blobs(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)
        reps = 10 if dev.type == "cuda" else 1
        variants = phase_kernels(x, w, c, dev, reps)
        breakdown = ({mode: kernel_breakdown(x, w, c, dev, mode) for mode in ("highest", "default")}
                     if dev.type == "cuda" else {})
        del w, c
        last_card = phase_last_card(dev)
        max_iter = 20 if dev.type == "cuda" else 5
        fit, km_model = phase_fit(x, dev, cfg, max_iter)
        # the front doors' K-Means is held to this fit (31), before the
        # online phases move the model's centers
        km_ref = (fit["launches"], km_model.cluster_centers_.copy())
        phase_loop_parity(x, dev, cfg, max_iter)
        serve_cfg = SERVE_TINY if args.rehearse else SERVE_FULL
        # phase 28 serves requests from the blobs' first rows: a host
        # copy, so the table frees here, before the phases between
        km_slab = x[: serve_cfg["slab"]].cpu().numpy()
        del x
        # K1 above d = 256 (35)
        wide = phase_kmeans_wide(WIDE_TINY if args.rehearse else WIDE_FULL, dev, smi)
        pca_cfg = PCA_TINY if args.rehearse else PCA_FULL
        als_cfg = ALS_TINY if args.rehearse else ALS_FULL
        pca_vars = phase_pca_kernels(pca_cfg, dev, reps)
        pca_fit = phase_pca_fit(pca_cfg, dev)
        pca_rand = phase_pca_randomized(pca_cfg, dev, smi)
        data = als_data(als_cfg)
        solves, grams = phase_als_kernels(als_cfg, data, dev, 2 * reps)
        als_fit, als_model = phase_als_fit(als_cfg, data, dev)
        als_block, block_model = phase_als_block_fit(als_cfg, data, dev, als_model)
        # the headline K-Means and the ML-25M ALS served, updated online
        serve_online = phase_serve_online(serve_cfg, als_cfg, dev, km_slab, km_model, data,
                                          als_model)
        # the serving front on the same model (29)
        serve_traffic = phase_serve_traffic(TRAFFIC_TINY if args.rehearse else TRAFFIC_FULL,
                                            dev, km_slab, km_model, args.rehearse)
        del km_slab, km_model
        ckpt = phase_ckpt(CKPT_TINY if args.rehearse else CKPT_FULL, als_cfg, data, dev,
                          args.rehearse)
        rate = pinned_h2d_rate(dev)
        stream_als = phase_stream_als(als_cfg, data, dev, als_model, rate)
        block_2d, block_2d_model = phase_als_block_2d(als_cfg, data, dev)
        # the factor-sharded serving on the two block fits' live layouts
        # (30), then the front doors (31)
        sharded, two_d_sweep = phase_serve_sharded(als_cfg, data, dev, args.rehearse,
                                                   block_model, block_2d_model)
        del block_model, block_2d_model
        front = phase_front_doors(FRONT_TINY if args.rehearse else FRONT_FULL, als_cfg, data,
                                  dev, two_d_sweep, sharded["two_d"]["fit_launches"], km_ref)
        del two_d_sweep
        del als_model
        block_stream = phase_block_stream(als_cfg, data, dev)
        del data
        stream_km, host, streamed_model = phase_stream_kmeans(
            STREAM_TINY if args.rehearse else STREAM_FULL, dev)
        route = phase_stream_route(STREAM_TINY if args.rehearse else STREAM_FULL, host,
                                   streamed_model, dev)
        del host, streamed_model
        stream_pca = phase_stream_pca(STREAM_PCA_TINY if args.rehearse else STREAM_PCA_FULL,
                                      dev, rate)
        sparse = phase_sparse_input(SPARSE_TINY if args.rehearse else SPARSE_FULL, dev)
        ring_cfg = RING_TINY if args.rehearse else RING_FULL
        rings = phase_ring_kernels(ring_cfg, dev, reps)
        sharded = phase_sharded_fit(SHARDED_TINY if args.rehearse else SHARDED_FULL, dev)
        dp = phase_dp_fit(DP_TINY if args.rehearse else DP_FULL, dev)
        pca_mesh = phase_pca_mesh_fit(pca_cfg, dev)
        mp = phase_mp(dev, False, args.rehearse)
        # the autotuner (32), its world leg world "a"'s, its merged streams
        # phase 27's and that world's
        tuning = phase_tuning(TUNE_TINY if args.rehearse else TUNE_FULL, dev, args.rehearse,
                              world_a=mp["a"], tel_sink=tel_sink_path())
        # the native host layer (33): fits from the example formats' files
        ingest = phase_ingest(INGEST_TINY if args.rehearse else INGEST_FULL, dev, smi)
        # the float64 parity lane (34)
        x64 = phase_x64(X64_TINY if args.rehearse else X64_FULL, dev, smi)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    main_v = next(v for v in variants if v["mode"] == "highest" and not v["need_cost"])
    entries = [{
        "name": kmeans_kernel.KERNEL, "route": "cuda",
        "source": "oap_mllib_tpu_torch/csrc/kmeans_accumulate.cu",
        "replaces": REPLACES,
        "launches": fit["launches"][kmeans_kernel.KERNEL],
        "max_abs_err": main_v["max_abs_err"], "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"], "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"], "library_ms": main_v["library_ms"],
        "library_call": "torch.matmul(x, c.T): the cross product only",
        "assign_route": main_v["route"],
        # the assignment's routes by depth: the main path's, and the wide
        # rows' at phase 35's shapes
        "assign_routes": {"wgmma": "d <= 256", "wgmma_wide": "d > 256"},
        "shape": cfg, "variants": variants, "breakdown_ms": breakdown,
        "last_card": last_card,
        "wide": {"variants": wide["variants"], "fit": wide["fit"], "hgmma": wide["hgmma"]},
    }]
    # each kernel's headline: the variant its path's fit runs most
    headline = [
        (pca_kernel.KERNEL, "pca_moments.cu", PCA_REPLACES, pca_fit["launches"],
         next(v for v in pca_vars if v["pass"] == "gram" and v["mode"] == "highest"),
         pca_vars, {"n": pca_cfg["shapes"][0][0], "d": pca_cfg["shapes"][0][1],
                    "pass": "gram", "mode": "highest"}),
        (als_kernel.SOLVE, "als_solve.cu", SOLVE_REPLACES, als_fit["launches"],
         next(v for v in solves if v["r"] == als_cfg["rank"] and v["gram"]),
         solves, {"n": als_cfg["n_users"], "r": als_cfg["rank"], "gram": True}),
        (als_kernel.GRAM, "als_factor_gram.cu", GRAM_REPLACES, als_fit["launches"],
         next(v for v in grams if v["r"] == als_cfg["rank"]),
         grams, {"n": als_cfg["n_users"], "r": als_cfg["rank"], "mode": "highest"}),
    ]
    for name, src, replaces, launches, v, all_v, shape in headline:
        entries.append({
            "name": name, "route": "cuda", "source": f"oap_mllib_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": v["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"], "library_call": v["library_call"],
            "shape": shape, "variants": [measured(u) for u in all_v],
        })
    # the ring at the shape, world and layout the sharded fit gives it
    main_ring = next(v for v in rings if v["shape"] == list(ring_cfg["shapes"][0])
                     and v["world"] == SHARDED_FULL["data"] and v["segments"] == 1)
    entries.append({
        "name": ring_kernel.KERNEL, "route": "cuda",
        "source": "oap_mllib_tpu_torch/csrc/ring_reduce.cu", "replaces": RING_REPLACES,
        "launches": sharded["launches"][ring_kernel.KERNEL],
        "max_abs_err": main_ring["max_abs_err"], "ms": main_ring["ms"],
        "plain_ms": main_ring["plain_ms"], "bound_ms": main_ring["bound_ms"],
        "bound_by": main_ring["bound_by"], "library_ms": main_ring["library_ms"],
        "library_call": main_ring["library_call"],
        "shape": {"rows": main_ring["shape"][0], "cols": main_ring["shape"][1],
                  "world": main_ring["world"], "segments": 1,
                  "layout": main_ring["layout"]},
        "variants": rings,
        # across processes (IPC): the main ring of world "a" at the
        # sharded fit's shape, and every shape's
        "cross_process": next(v for v in mp["a"][0]["mp_ring"]
                              if v["shape"] == list(ring_cfg["shapes"][0])),
        "cross_process_variants": mp["a"][0]["mp_ring"],
        # across processes at the sheets the streamed passes packed
        "cross_process_stream_sheets": mp["a"][0]["mp_stream"]["ring_sheets"],
    })
    # every path's launches of each kernel, from the runs above
    by_path = {
        kmeans_kernel.KERNEL: {"fit": fit["launches"][kmeans_kernel.KERNEL],
                               "dp_fit": dp["launches"][kmeans_kernel.KERNEL],
                               "sharded_fit": sharded["launches"][kmeans_kernel.KERNEL],
                               "stream_kmeans loop":
                                   stream_km["loop"]["launches"][kmeans_kernel.KERNEL],
                               "stream_kmeans fit":
                                   stream_km["fit"]["launches"][kmeans_kernel.KERNEL],
                               "stream_route": route["launches"][kmeans_kernel.KERNEL],
                               "kmeans_wide fit (2^20 x 960)":
                                   wide["fit"]["launches"][kmeans_kernel.KERNEL],
                               "sparse_input (two fits)":
                                   sparse["launches"][kmeans_kernel.KERNEL],
                               **{f"ladder {leg}": ladder[leg]["launches"][kmeans_kernel.KERNEL]
                                  for leg in ("a_transient", "b_halving", "c_spill",
                                              "d_precision", "f_exhausted")},
                               **{f"ckpt a {tag}": n for tag, n
                                  in ckpt["a_kmeans"]["launches"].items()},
                               "ckpt d relaunch": ckpt["d_kill"]["launches_resumed"][
                                   kmeans_kernel.KERNEL]},
        pca_kernel.KERNEL: {"pca_fit": pca_fit["launches"][pca_kernel.KERNEL],
                            **{f"pca_mesh_fit {v['mesh']['data']}x{v['mesh']['model']}":
                               v["launches"][pca_kernel.KERNEL] for v in pca_mesh},
                            "stream_pca": stream_pca["f32"]["launches"][pca_kernel.KERNEL],
                            "stream_pca bf16": stream_pca["bf16"]["launches"][pca_kernel.KERNEL],
                            "sparse_input (two fits)": sparse["launches"][pca_kernel.KERNEL],
                            **{f"pca_randomized {v}": pca_rand[v]["launches"][pca_kernel.KERNEL]
                               for v in ("eigh", "randomized")},
                            **{f"ckpt c {tag}": n
                               for tag, n in ckpt["c_pca"]["launches"].items()}},
        als_kernel.SOLVE: {"als_fit": als_fit["launches"][als_kernel.SOLVE],
                           "als_block_fit": als_block["launches"][als_kernel.SOLVE],
                           "stream_als": stream_als["launches"][als_kernel.SOLVE],
                           "als_block_2d": block_2d["launches"][als_kernel.SOLVE],
                           **{f"block_stream r{v['rank']} {v['item_layout']}":
                              v["launches"][als_kernel.SOLVE] for v in block_stream},
                           "ladder g_als": ladder["g_als"]["launches"][als_kernel.SOLVE],
                           "ckpt b resumed": ckpt["b_als"]["launches"]["resumed"][
                               als_kernel.SOLVE],
                           "ckpt e resharded": ckpt["e_reshard"]["launches_resumed"][
                               als_kernel.SOLVE]},
        als_kernel.GRAM: {"als_fit": als_fit["launches"][als_kernel.GRAM],
                          "als_block_fit": als_block["launches"][als_kernel.GRAM],
                          "stream_als": stream_als["launches"][als_kernel.GRAM],
                          "als_block_2d": block_2d["launches"][als_kernel.GRAM],
                          **{f"block_stream r{v['rank']} {v['item_layout']}":
                             v["launches"][als_kernel.GRAM] for v in block_stream},
                          "ladder g_als": ladder["g_als"]["launches"][als_kernel.GRAM],
                          "ckpt b resumed": ckpt["b_als"]["launches"]["resumed"][
                              als_kernel.GRAM],
                          "ckpt e resharded": ckpt["e_reshard"]["launches_resumed"][
                              als_kernel.GRAM]},
        ring_kernel.KERNEL: {"sharded_fit": sharded["launches"][ring_kernel.KERNEL],
                             "dp_fit": dp["launches"][ring_kernel.KERNEL],
                             "tuning sharded_fit segments=2": tuning["pinned"][
                                 "sharded_segments_2_launches"][ring_kernel.KERNEL]},
    }
    # the serving and online phase's launch paths (28)
    by_path[kmeans_kernel.KERNEL]["serve_online partial_fit"] = \
        serve_online["e"]["launches"][kmeans_kernel.KERNEL]
    by_path[kmeans_kernel.KERNEL]["serve_traffic partial_fit under a storm"] = \
        serve_traffic["d"]["launches"][kmeans_kernel.KERNEL]
    by_path[pca_kernel.KERNEL].update({
        f"serve_online ipca ({serve_online['b']['chunks']} chunks)":
            serve_online["b"]["launches"][pca_kernel.KERNEL],
        "serve_online ipca second delta": serve_online["b"]["delta_launches"][pca_kernel.KERNEL]})
    for name in (als_kernel.SOLVE, als_kernel.GRAM):
        by_path[name].update({
            "serve_online fold_in": serve_online["d"]["launches"][name],
            f"serve_online fold_in batched ({serve_online['d']['batches']} batches)":
                serve_online["d"]["batched_launches"][name],
            "serve_online fold_in delta.solve:err=2":
                serve_online["f"]["foldin_launches_before_fault"][name],
            "serve_online fold_in failed at batch 2":
                serve_online["f"]["mid_commit_launches"][name]})
    # the front doors' compat fits (31)
    by_path[kmeans_kernel.KERNEL]["front_doors compat KMeans"] = \
        front["a_kmeans"]["launches"][kmeans_kernel.KERNEL]
    by_path[pca_kernel.KERNEL]["front_doors compat PCA"] = \
        front["b_pca"]["launches"][pca_kernel.KERNEL]
    for name in (als_kernel.SOLVE, als_kernel.GRAM):
        by_path[name]["front_doors compat ALS (2-D, four ranks)"] = \
            front["c_als"]["launches"][name]
    for name, paths in mp_launches(mp).items():
        by_path[name].update(paths)
    # the ingest phase's fits from files (33)
    by_path[kmeans_kernel.KERNEL]["ingest K-Means from libsvm"] = \
        ingest["libsvm"]["launches"][kmeans_kernel.KERNEL]
    by_path[pca_kernel.KERNEL]["ingest PCA from csv"] = ingest["csv"]["launches"][pca_kernel.KERNEL]
    for name in (als_kernel.SOLVE, als_kernel.GRAM):
        by_path[name]["ingest ALS from ratings.dat"] = \
            ingest["ratings"]["als"]["launches"].get(name, 0)
    for fit in ("kmeans", "pca", "als", "sharded"):
        for name, n in telemetry[fit]["launches"].items():
            by_path[name][f"telemetry {fit} (off and armed alike)"] = n
    # the float64 forms of K1 and K2 (34): their launches on the f64 fits
    for name, src, replaces, v, variants, launches, shape in (
            (kmeans_kernel.KERNEL, "kmeans_accumulate.cu", REPLACES, x64["k1"][0], x64["k1"],
             x64["kmeans_fit"]["launches_float64"],
             {"n": cfg["n"], "d": cfg["d"], "k": cfg["k"], "dtype": "float64"}),
            (pca_kernel.KERNEL, "pca_moments.cu", PCA_REPLACES, x64["k2"],
             [x64["k2"], x64["k2_wide"]], x64["pca_fit"]["launches"][pca_kernel.KERNEL],
             {"n": X64_FULL["pca"][0], "d": X64_FULL["pca"][1], "pass": "gram",
              "dtype": "float64"})):
        entries.append({
            "name": f"{name}_f64", "route": "cuda", "source": f"oap_mllib_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches, "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            "library_call": v["library_call"],
            "shape": shape, "variants": [measured(u) for u in variants],
            "x64": {k: x64[k] for k in ("routes", "als", "small", "ptxas", "wall_s")}})
    by_path[f"{kmeans_kernel.KERNEL}_f64"] = {
        "x64 fit": x64["kmeans_fit"]["launches_float64"],
        "x64 streamed loop": x64["routes"]["stream_loop"]["launches"],
        "x64 streamed fit": x64["routes"]["stream_kmeans"]["launches"][kmeans_kernel.KERNEL],
        "x64 partial_fit": x64["routes"]["partial_fit"]["launches"][kmeans_kernel.KERNEL],
        "x64 mesh 4x1": x64["routes"]["mesh_4x1"]["launches"][kmeans_kernel.KERNEL]}
    by_path[f"{pca_kernel.KERNEL}_f64"] = {
        "x64 fit": x64["pca_fit"]["launches"][pca_kernel.KERNEL],
        "x64 streamed fit": x64["routes"]["stream_pca"]["launches"][pca_kernel.KERNEL],
        "x64 IncrementalPCA": x64["routes"]["incremental_pca"]["launches"][pca_kernel.KERNEL]}
    by_path[ring_kernel.KERNEL]["x64 mesh 2x2 (f64: psums)"] = \
        x64["routes"]["mesh_2x2"]["launches"][ring_kernel.KERNEL]
    for entry in entries:
        entry["launches_by_path"] = by_path[entry["name"]]
    if args.rehearse:
        # host-clock numbers of the plain versions: no device metric
        print("rehearsal passed (CPU, plain versions; times are host times)")
        return 0
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
