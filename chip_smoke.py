"""Chip smoke test of the PyTorch/CUDA port: builds its kernels, holds each
against its plain version on the card, serves Llama-2-7B-shaped requests
(random bf16 weights from a seed, full width) through the port's engine and
OpenAI server, again 8 decode steps per dispatch, again through the
write-then-attend decode, again with int8 weights and an int8 KV cache, and
through the write-then-attend decode over int8 pages, speculates (a
self-draft, a 1B-shape draft over int8, prompt lookup), runs the other
inference workloads (SD3-shape text-to-image through K1, bge-small
embeddings, whisper-base transcription, CLIP-L), runs the operations layer
over the same model (the gateway's health, alert and incident routes, the
correctness canary with a planted drift), the failure and fleet layers over
the same weights (disaggregated prefill/decode, live KV migration, reactive
failover, the watchdog, the router front), LoRA-fine-tunes the same model
through ``Trainer`` and then an int8 base of it, serves Mixtral-8x7B (bf16
at depth 8, int8 at full depth through the OpenAI server), runs the
serverless surface on the card (functions, a Cls and Llama-2-7B behind
``@app.server`` in spawned GPU containers, and the CLI), then the rest of the
platform layer (a snapshot-restored engine, a resumable LoRA fine-tune,
streaming ASR over a websocket, a sandbox, an OCI export), then serves
Llama-2-7B with int4 weights on the int4 matmul kernel and trains QLoRA over
them, DreamBooth-LoRA on the SD3-shape MMDiT, ControlNet's DiT and
whisper-base, runs tensor and data parallelism over torch.distributed,
holds the f32 instances of the flash kernels, serves a LLaVA-shape
vision-language model through the OpenAI server, trains GPT, an f32 Llama's
LoRA, the detector, OCR, SAM and the video DiT, runs GRPO, and prints
per-kernel times beside their bounds.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
1. build the CUDA kernels from ``modal_examples_tpu_torch/csrc`` (the
   ptxas register and spill report of the flash forward, dQ and dK/dV
   kernels, the int8 matmul and the four decodes logged), and read their
   SASS with ``cuobjdump``: the first four must hold wgmma (``HGMMA``) and
   TMA load (``UTMALDG``) instructions, the four decode kernels (ragged and
   write-then-attend, bf16 and int8 pages) cp.async (``LDGSTS``);
2. each kernel against its plain version at the main paths' shapes
   (Hq=Hkv=32, D=128, page_size 16) and a GQA shape (Hkv=8); the flash
   forward also at a ragged S=300 (causal and not), a chunk at
   q_offset=496 over a ragged Skv=700, and D=64, 256 and 80 (zero-padded
   to the 128 instance by the wrappers); the flash backward kernels also
   non-causal, at a ragged S=300, at D=32, 64, 256 and 80 and with a
   nonzero lse cotangent; the int8 matmul at M = 1, 8, 64, 65,
   300 and 2048 over every weight shape of the model (each must take a TMA
   path; the path is logged) and a ragged 4000 x 11000, each launched twice
   and required bitwise equal; the ragged decodes (bf16 and int8 pages) at
   Hkv=32 and 8, prefixes 0..1000 and at the kernels' split edges, held
   per (sequence, head) row, launched twice and required bitwise equal, with
   the same check shown to refuse two planted faults (the last page of the
   longest prefix dropped, the last split of its rows dropped from the
   merge); the int8 scatter bitwise at a decode step, a prefill batch (its
   blocks striding), one layer's view through ``scatter_kv_layer``, one
   token, 37 tokens at Hkv=5 and D=256, Hkv=8, D=64 and D=256, each with an
   all-zero row (scale 1.0, data 0) and a row of ties (rounded half to
   even), with the same check shown to refuse two planted faults (a row
   left unwritten, a scale from the neighbouring head); the write-then-attend
   decodes (bf16 and int8 pages) over one layer's pages at Hkv=32 and 8,
   contexts 0..1001 with a dead slot on trash page 0 and contexts at the
   split edges, held per (sequence, head) row, an empty context exactly
   zero, launched twice and required bitwise equal, with the same check
   shown to refuse planted faults (bf16: the last 64-row chunk skipped, the
   last split dropped, K2's bf16 probabilities; int8: the last page and the
   last split dropped); then K4 with the folded write (the step's new rows
   written by K4 itself, ``write_then_attend``) against K3 over the
   one-layer view followed by K4, pages and output bitwise, at those
   contexts with dead slots (on a stale table, with an empty context, on an
   all-trash table) and at the split edges, G = 1 and 4, and over verify
   chains that straddle the split edges and run past the table's end; and
   against its plain twin at K4's limits; the check shown to refuse two
   planted faults (the longest context's write skipped, so its stale row
   is read; the row written by the wrong split's block, a variant of the
   kernel built for it under ``build/variants``);
3. the engine serving 8 requests (prompts of 20..700 tokens, one chunked),
   with the launch counters zeroed just before and read just after: every
   serving kernel must have launched, the decode kernel n_layers x the
   dispatched decode steps (a block's 8, a macro-step's N, either cut to
   the largest budget of its slots: the pipelined loop runs every
   dispatched step on the card, and the engine's ``stats.steps`` counts
   those with a live lane); then prefill + one
   decode step against a dense plain forward on the card; then the same
   burst with ``decode_steps = 8`` (the macro-step program), counters
   zeroed: the decode kernel n_layers x the dispatched steps, greedy and
   seeded rows token-identical to N=1;
4. the OpenAI server: one completion, one streamed chat completion;
   then (phase 3b) write-then-attend serving: ``paged_impl=
   "pallas-writeback"`` at ``decode_steps=8``, then 1, counters zeroed each
   time: the writeback decode kernel n_layers x decode steps times, each
   launch folded (writing the step's rows), no ragged decode launch, the
   scatter only in prefills (once a prefill call), every page returned;
   then at N=1 with the writes unfolded (K3, then K4); N=8, N=1 and the
   unfolded run token-identical; prefill + one writeback decode step
   against a dense plain forward;
   then int8 serving: the same weights quantized (``quantize_llama``) in an
   engine with an int8 KV cache serving the same 8 requests, counters
   zeroed: the int8 decode kernel n_layers x decode steps times, no bf16
   decode or scatter launch, the int8 scatter at least once, the int8
   matmul a multiple of 7 x n_layers + 1 and at least that many per decode
   step; weights and cache at most 0.52 of their bf16 bytes; prefill + one
   decode step against a dense plain forward over the same int8 weights
   and the same int8 cache rows; then (phase 3b over int8 pages) the same
   int8 weights and cache at ``paged_impl="pallas-writeback"``,
   ``decode_steps=8``, counters zeroed: the int8 write-then-attend decode
   n_layers x decode steps times and no other decode kernel, the int8
   scatter at least once a layer a step, every page returned, and the dense
   check through the writeback decode step;
   then training: Llama-2-7B (full depth, frozen random bf16 base) with
   rank-16 LoRA on all seven projections, B=2 x S=512, through
   ``Trainer.train_step``: the first step's adapter gradients against the
   same step with ``attn_impl="xla"``; then, counters zeroed, 1 warm-up and
   4 timed steps in which the flash forward, dQ and dK/dV kernels must each
   launch exactly n_layers x 5 times;
5. per-kernel numbers on earlier lines, each kernel and library call
   timed two ways (CUDA events): the median of single launches (``ms``,
   ``library_ms``) and 50 back-to-back launches (``ms_b2b``,
   ``library_ms_b2b``); the four decode kernels cycled over four layers of
   one cache (so their rows come from HBM) and also by their device time
   (``device_ms``: 40 calls queued behind a spin kernel between CUDA
   events, null where the host could not keep ahead); the two
   scatters' device time and byte
   bound also at a prefill batch and one layer's view (``shapes``); then
   the card's name and power limit, then the result line.
6. the engine surface, over the same resident weights (after phase 3b over
   int8 pages, before training): (6a) a Llama-2-7B-width checkpoint at
   depth 2 (two shards, 1.3 GB) written with the port's safetensors writer
   and loaded through ``build_engine(model_dir=...)`` in bf16 and with int8
   weights and pages, each tree held bitwise (int8 against
   ``quantize_weight_host``), each engine serving the burst and passing the
   dense check, the int8 one launching K7, K2-int8 and K3-int8, the load
   time and rate logged; (6b) 8 requests sharing a 320-token system prompt
   with the prefix cache on (twice) and off: tokens identical,
   ``cached_tokens`` the page arithmetic, every private page back and the
   cached pages the trie's distinct full pages; and one prefix's pages held
   bitwise when rewritten at buckets 128 and 512, from batch rows 0 and 3
   and as a chunk (bf16 and int8 pages); (6c) a 1500-token prompt arriving
   while 7 streams decode under ``max_prefill_tokens_per_tick=512``, stepped
   by hand: at least 3 prefill ticks with a decode block in each, every
   token equal to the unbudgeted run's, each tick's host wall and K1
   launches logged; (6d) with a fake clock: a deadline passing mid-decode
   ends with "deadline" and returns the pages, a queued one is cancelled
   before it takes a slot, an interactive request is admitted before
   earlier default ones.
7. the pipelined engine at full width (after phase 6, before training; the
   resident weights, the profiler on): 16 requests over 8 slots at
   ``decode_steps`` 1 and 8, counters zeroed (K1, K2, K3 launched, K2
   n_layers x the dispatched steps), a block read with the next one in
   flight, slots recycled under a block in flight, parked first tokens
   read after a dispatch, one dispatch under PyTorch's sync debug mode
   reporting no synchronizing operation, every page back, N=8 and each
   request served alone token-identical to the burst; the OpenAI server's
   ``n = 3`` against its seeded singles, ``x-mtpu-request-id`` on the 200
   and the stream, ``/metrics`` counting the engine's stats with no name
   twice; logged: the profiler's phases (each tick's within 5% of its
   total), its host share, dispatch host ms against the block's device span, the
   usage meter's work over the served wall at the card's peaks (each share
   at most 1.0), and the burst's tok/s and TTFT beside phase 3's.
8. speculation at full width (after phase 7, before training; the resident
   weights, ``SERVE_KW``), with the counters zeroed just before each burst
   and read just after: (8a) the verify route (``paged_verify_attention``:
   the write-then-attend kernels over 8 slots x 5 chain positions, contexts
   1..1005) against the plain ``reference.paged_verify_attention`` on the
   card at K4's tolerances, bf16 and int8 pages, bitwise run to run, a
   planted fault (contexts one short) refused, with its device time, the
   plain version's and the byte bound; and ``verify_step`` over 5 positions
   against 5 ``decode_step`` calls (cosine > 0.999, max rel err < 5e-2);
   (8b) a self-draft (``speculative=(cfg, 4)``, the target's own tensors)
   serving phase 3's burst: the verify's K4 n_layers x rounds times, K2
   n_layers x (the draft's 5 steps a round plus the fallback blocks' steps),
   every greedy token the dense plain forward's argmax or within 5e-2 x its
   largest logit (the others counted), finish reasons and pages, the rows
   identical to phase 3's, the usage meter's shares in (0, 1]; (8e) the
   OpenAI server's ``/metrics`` on that engine: the speculation series equal
   to its stats; (8c) int8 weights and pages with the random 1B-shape draft
   of ``bench.py``'s ``llama2-7b-int8-spec-draft1b`` at γ = 4 (the draft on
   K2-int8 and K3-int8, the verify on K3-int8 and K4-int8, K7), the same
   exactness check over the int8 weights and dequantized cache rows, and
   the burst's tok/s beside a non-speculating int8 engine's (one burst
   each); (8d) prompt lookup (``("ngram", 4)``) over prompts that repeat a
   phrase, the same checks. Its launches join the kernels line.
9. the north star's other inference workloads at full width on random
   weights from seeds (after phase 8, before training): (9a) K1 at the
   SD3 MMDiT's joint attention shape (B=1, H=24, S=154+1024, D=64, full)
   against its plain version, bitwise run to run, a planted fault (the
   ragged last key tile left out) refused, timed beside SDPA; (9b)
   ``bench.py``'s text-to-image run: ``mmdit_sample`` at
   ``MMDiTConfig.sd3_shape()`` in bf16 (modulation leaves drawn nonzero),
   4 steps at guidance 4, then the SD3 VAE's decode to 512 x 512: K1 2 x 4
   x 24 times an image, the latents against the reference's plain
   attention products (a planted fault, the last block's attention zeroed,
   refused), img/s split into sampling and decode; (9c) bge-small
   embeddings at B=256, S=512 (unit norm, a half-masked batch equal to the
   half alone, two rows against the CPU run, tok/s); (9d) whisper-base over
   8 x 30 s, 64 greedy tokens (the encoder with cuDNN's TF32 allowed
   around it and one chunk's tokens against the CPU run, by the top-2
   margin rule; ``align_tokens``; a ``StreamingTranscriber``; x-realtime);
   (9e) CLIP-L on 2 x 77 tokens against the CPU run. Its K1 launches join
   the kernels line; K1's row carries 9a's figures under ``joint``.
10. Mixtral-8x7B (after phase 12, every earlier tree freed): (10a) K7 at
   the expert products, M = 8 and 2048 over [4096, 14336] and
   [14336, 4096], against ``qmm_plain`` within 1e-3 of its largest value,
   bitwise run to run, a planted fault (the last K tile left out) refused,
   timed single, back to back and by device time beside the bf16 GEMM
   (K7's row carries these under ``expert``); (10b) ``mixtral_8x7b()`` in
   bf16 at full width and depth 8 (23.7 GB) through the ragged engine at
   N=1 and 8 (rows identical) and the write-then-attend engine, counters
   zeroed around each burst (the decode kernel n_layers x dispatched
   steps), each structure's prefill + decode step against the plain
   reference with f32 expert activations (cosine > 0.999, max rel err <
   5e-2) with the reference routed through the served choices (the free-
   running reference's numbers logged), the choices against the plain
   routing of the same layer inputs (equal outside ties within 1e-6, ties
   counted) and against the free-running reference's (at least 80% equal,
   the rest counted), and the port's ``forward`` on the card held the same
   way;
   (10c) ``build_engine("mixtral-8x7b", quantization="int8")`` at 32
   layers with an int8 cache: weights at most 0.52 of the bf16 bytes,
   phase 3's burst (K2-int8 n_layers x dispatched steps, K7 (4 + 3 x 8) x
   32 + 1 a pass), the same dense and routing checks over the int8 weights
   and cache rows, the burst again through ``OpenAIServer``, tok/s, TTFT
   and the peak memory (under the card's). Its launches join the kernels
   line.
11. the serverless surface (after phase 10 freed Mixtral): app files
   written into a temporary directory under ``build/``, each importing
   ``modal_examples_tpu_torch`` and nothing of the JAX package, driven
   through ``app.run()``, ``ServerHandle.serve()`` and the CLI; containers
   are spawned processes that find phase 1's kernel libraries built (each
   reports the sources it compiled: none; the script alone still builds
   every kernel, in phase 1, before any container starts). (11a) ``@app.function(gpu=
   "H100")``: ``.remote``, ``.map`` over 4 inputs and ``.spawn``, each
   running K1 at the engine's prefill batch in the container against its
   plain version there (2e-2) with the container's launch count; a function
   without ``gpu=`` sees no card; ``gpu="H100:2"`` fails its boot naming the
   spec; a ``@app.cls(gpu="H100")`` probe's cold boot split into spawn and
   import, ``@enter`` (a CUDA context and every kernel library loaded) and
   first result, and the warm round trip (median of 20 no-op calls).
   (11b) ``@app.server(gpu="H100")`` whose ``@enter`` builds phase 3's
   Llama-2-7B engine from phase 3's seed and starts ``OpenAIServer``:
   phase 3's 8 requests as concurrent streamed ``/v1/completions``, every
   greedy and seeded row equal to phase 3's direct burst, the container's
   K1, K2 and K3 counts (zeroed before the burst) above 0, ``@exit``
   stopping the server and its port closed; boot to port-ready split into
   spawn and import, weights, engine and server; burst tok/s, TTFT and the
   container's peak memory. (11c) ``@app.cls(gpu="H100")`` with the engine
   loaded once in ``@enter`` and a ``@batched`` ``generate``: ``.remote``,
   then ``.map`` over phase 3's 8 prompts (one batch, submitted back to
   back as phase 3's burst): rows equal to the direct burst, one ``@enter``
   in one container. (11d) ``python -m modal_examples_tpu_torch run`` on
   11a's file: exit 0 and K1's result printed. The containers' launches
   join the kernels line, marked ``container_launches`` in their rows.
12. LoRA on the int8 base (after training freed the bf16 base, before
   Mixtral): ``init_quantized_llama`` at Llama-2-7B's full width and depth
   (random int8 weights drawn on the card), rank 16 on all seven
   projections (f32 adapters), B=2 x S=512: the first step's adapter
   gradients through K7 and the flash kernels against the same step through
   ``qmm_plain`` and the xla attention (cosine >= 0.999 per target); then,
   counters zeroed, 1 warm-up and 3 timed ``Trainer`` steps: K7 7 x
   n_layers + 1 times a step, K1, K5 and K6 n_layers times a step, finite
   losses, the b adapters moved, the peak memory below the bf16 base's. Its
   launches join the kernels line.
13. the operations layer (after phase 9, before training; the resident
   bf16 weights, ``SERVE_KW``): a gateway's ``/healthz``, ``/alerts`` and
   ``/incidents`` over HTTP; the canary's golden set through the engine
   (counters zeroed: K1, K2 and K3 launched): a first round records the
   golden, a second passes bit-exact, a third with
   ``engine.canary_token_corrupt`` armed reports drift on the first probe's
   first token and captures a ``canary_drift`` incident bundle naming the
   probe request, which ``/incidents`` then lists; the fingerprint names
   ``cuda`` and this card; the probes' TTFT and e2e logged. Its launches
   join the kernels line.
14. the platform layer's rest (after phase 11, in the same spawned-container
   setup; app files under ``build/``). (14a) ``@app.cls(gpu="H100",
   enable_memory_snapshot=True)``: its ``@enter(snap=True)`` draws
   Llama-2-7B-width weights at depth 4 on the card from phase 3's seed
   (2.1 GB of bf16), its ``@enter()`` loads the kernel libraries and builds
   the engine; three boots, each a fresh container: a miss that captures, a
   hit that runs no snap hook (counted inside the container through a
   ``Dict``), and a fallback after one byte of the payload is flipped; each
   serves phase 3's first 4 prompts greedy with K1, K2 and K3 counted above
   0, every boot's rows equal to the first's; logged: the entry's bytes,
   capture and restore seconds and GB/s, and each boot's split (spawn,
   interpreter, ``import torch``, the app file, the kernel libraries, the
   snap hooks or the restore, the other hooks). (14b) a LoRA fine-tune in
   ``@app.function(gpu="H100")`` (Llama-2-7B bf16, full depth, rank 16 on
   all seven projections, B=2 x S=512), checkpoints on a ``Volume``:
   attempt 1 trains 2 steps, saves, commits and raises; the retry (a fresh
   container) reloads, resumes at step 2 with the adapters attempt 1 saved
   (bitwise) and trains steps 3-4; its losses equal an uninterrupted 4-step
   run's (bitwise when phase 2 found the flash backward kernels bitwise
   from launch to launch, else 1e-3 relative); K1, K5 and K6 n_layers times
   a step in each container; progress through a ``Dict``; logged: the step
   median, the checkpoint's bytes and its write-plus-commit seconds. (14c)
   the gateway's ``@websocket_endpoint`` streaming whisper-base on the card
   (phase 9's weights): 8 s of seeded audio in 0.5 s float32 chunks, then
   "end"; the final transcript equal to an in-process
   ``StreamingTranscriber``'s over the same chunks, committed text never
   retracted; the first partial's latency logged. (14d) a ``Sandbox`` exec
   (``nvidia-smi`` names the card, an exit code, an exec timeout) and
   ``Image.cuda_base().add_local_file(...).export_oci(...)`` with every
   digest checked. The containers' launches join the kernels line, marked
   ``container_launches``.
15. the failure and fleet layers (after phase 13, before training; phase
   3's resident bf16 weights under every engine, none copying them;
   ``SERVE_KW``). (15a) phase 3's 700-token prompt prefilled by
   ``prefill_sync``, its 44 pages extracted, serialized (MTKV1),
   deserialized and adopted into a second engine's cache: bitwise on the
   card, and the bytes equal to the same pages copied page by page into a
   CPU cache and serialized there; bytes and GB/s of each step logged.
   (15b) one prefill replica (its loop never runs) and two decode replicas
   behind ``DisaggCoordinator`` serve phase 3's 8 requests twice: staged
   (every request prefilled and shipped while the decode loops are stopped:
   K1 and K3 only on the prefill side, then K2 and K3 only on the decode
   side) and live (the decode loops running, a ``FleetWatchdog`` at the
   reference's thresholds polling: every replica healthy throughout);
   greedy and seeded rows token-identical to a unified engine serving each
   request alone, finish reasons equal, every page back on all three
   engines; per-request TTFT and the pages, bytes and seconds migrated
   logged; whether the alone rows equal phase 3's batched burst is logged
   as a finding. (15c) the burst, placed while the decode loops are
   stopped, decoding on decode replica A, the 4
   longest prompts' requests moved to B mid-decode by ``migrate_live``
   (four threads): token-identical to the unmigrated rows, texts too.
   (15f) ``OpenAIServer(router=coordinator)`` answers a completion and a
   stream over HTTP, their requests carrying the unified tokens. (15d)
   ``engine.scheduler_crash`` armed while only A's loop runs: the streams,
   consumed through ``stream_with_failover``, resume on B with the same
   request objects, the held rows' tokens and streamed texts equal to the
   uninterrupted run's (no duplicated character). (15e)
   ``engine.scheduler_freeze`` on A under a ``FleetWatchdog``: A goes
   degraded (router weight 0.25; a new request lands on B) and then wedged
   (error-stopped; the frozen stream resumes on B), the peer stays healthy,
   the gateway's ``/health`` and ``python -m modal_examples_tpu_torch
   health`` show it. Then 15a and 15b over int8 pages (K3-int8, K2-int8).
   The phase's peak memory is logged; its launches join the kernels line.
16. the prefix tiers, the fleet autoscaler and the chaos runner (after
   phase 15, before training). (16a) phase 6b's 320-token shared prompt (20
   pages) in 8 rows through an engine with ``tiered_prefix=`` over an
   ephemeral ``Volume`` (shared store, replica "a", the 64 MiB host tier)
   beside the same rows with the cache off: served, the 20 pages recorded,
   the trie evicted (the spill: extract, serialize, demote timed, the
   host/volume split logged), served again: the promoted pages bitwise equal
   to the recorded ones before the prefill's rewrite and after the request,
   the first row's ``cached_tokens`` 16 x the pages promoted, every row's
   tokens the cache-off run's, every page back; the promote's volume read,
   deserialize and adopt timed, and the promoted prompt's TTFT against the
   cache-off one; bf16, then int8 pages. (16b) replica "b" over a's store
   promotes what a demoted (volume hits from a peer);
   ``tiered.volume_corrupt`` drops the block in flight, the stored files
   unchanged, the prompt recomputed; ``prefix_store.owner_death`` kills the
   chain's owner mid-spill and the survivor takes its lease over
   (``owner_takeover`` journaled) and promotes warm; tokens identical
   throughout. (16c) a ``FleetAutoscaler`` over a ``PrefixAffinityRouter``
   of Llama-2-7B-width replicas at depth 4 built by a
   ``SnapshotWarmFactory`` and ticked under a fake clock: 16 requests over 8
   slots scale up on ``queue_pressure`` with a warm (snapshot-restored)
   boot, the new replica's rows the seed's; an idle tick scales it down and
   its two live streams migrate to the seed token-identically before its
   engine stops; ``fleet.jsonl`` and ``/fleet`` agree; one load-generator
   step through ``OpenAIServer(router=)``. (16d) ``run_chaos(seed=0,
   strict=True)`` on the card (``LlamaConfig.tiny`` engines): every fault
   point fired, the invariants "ok" after all 15 episodes, 0 wedged,
   ``/chaos`` answering. The phase's seconds and peak memory are logged; its
   launches join the kernels line.
17. int4 weights and the training paths (after phase 14, every earlier
   tree freed; ``benchmarks_torch/int4_training.py`` runs it alone). (17a)
   K7-int4 (``csrc/quantized_matmul_int4.cu``, built in phase 1: each
   path's registers and spills logged, ``HGMMA``, ``UTMALDG`` and ``HMMA``
   in its SASS) against ``qmm_int4_plain`` at M = 1, 8, 64, 65, 300 and
   2048 over every Llama-2-7B weight shape and a ragged 4000 x 11000, and
   at Mixtral's expert shapes at M = 8: within 1e-3 of the plain version's
   largest value, bitwise run to run, each launch on its shape's path
   ("ring" at M <= 64, "wgmma" above, "masked" for the ragged shape), the
   check shown to refuse three planted faults (the nibbles read swapped and
   the last K split of the launch lost at M = 8, the last K tile lost at
   M = 2048); ``quantize_weight(bits=4)`` on the card bitwise the
   CPU's; its times at [8 | 2048, 4096] x [4096, 11008] over four weight
   copies (single, back to back, device time), the bound,
   the plain version, ``torch._weight_int4pack_mm`` where it computes the
   function, and the bf16 GEMM. (17b) ``llama2_7b()`` with int4 weights
   drawn by ``init_quantized_llama(bits=4)`` on the card (at most 0.53 of
   the same tree's int8 bytes, the payload exactly half) serving phase 3's
   burst over bf16 pages, counters zeroed: K7-int4 a multiple of 7 x 32 + 1
   and at least that a dispatched step, no K7, K2 32 x the dispatched
   steps, K1, K3; prefill + one decode step against the dense plain forward
   over the same int4 weights; every greedy token the dense forward's
   argmax or within 5e-2 of its largest logit; then ``OpenAIServer``;
   outside the timed burst, the dense check's and the server's K7-int4
   launches counted by path (both "wgmma" and "ring", no other).
   (17c) QLoRA: phase 12 over the int4 base (rank 16, f32 adapters, B=2 x
   S=512): the first step's adapter gradients through K7-int4 (every
   launch on "wgmma") and the flash kernels against ``qmm_int4_plain`` and
   the xla attention (cosine >= 0.999 per target), 1 + 2 counted
   ``Trainer`` steps (K7-int4 225 a step, K1, K5, K6 32), the peak below
   phase 12's. (17d) DreamBooth-LoRA on
   ``MMDiTConfig.sd3_shape()`` (bf16, modulation drawn nonzero), rank 16,
   alpha 32 over ``DIT_TARGETS`` through ``init_lora_tree`` and
   ``merge_tree`` (b = 0 merges to the base bitwise), B=2 of 512 px latents
   and 154 text tokens (joint S = 1178), ``mmdit_flow_loss``: the first
   step's adapter gradients through K1 and K5/K6 against the plain
   attention products (cosine >= 0.999 per target), 1 + 2 counted steps
   (K1, K5, K6 24 a step), step ms and peak; K5/K6 timed at that shape.
   (17e) ``flow_loss(control=)`` at ``controlnet.py``'s DiT config and
   whisper-base fine-tuned as ``fine_tune_asr.py`` does, 2 ``Trainer``
   steps each on the card, the first step's loss and gradients within
   ``CPU_AGREE`` of the port's CPU run (f32, TF32 off). K7-int4's row joins
   the kernels line; K5's and K6's carry 17d's shape under ``joint``.
18. Mixtral LoRA training on the capacity experts (right after phase 10,
   over 10c's int8 tree): Mixtral-8x7B at full width and depth, frozen
   random int8 base, rank-16 LoRA on ``wq/wk/wv/wo`` (f32 adapters), B=2 x
   S=512, cross entropy + 0.01 x aux from ``forward(moe_impl="capacity",
   return_aux=True)``, the experts through ``moe.CapacityExperts`` (one
   expert's f32 matrices alive at a time, nothing widened saved). The
   adapter gradients at a cut depth of 2 against the unplanned einsums,
   with flash and with ``attn_impl="xla"`` attention, routed as the first
   run (cosine >= 0.999 per target; the xla run routed freely logged);
   then 1 + 2 counted
   ``Trainer`` steps: K1, K5, K6 32 a step, K7 on the attention projections
   and lm_head, the first step's saved tensors watched (no floating tensor
   shaped as an expert stack or one expert's matrix), step ms, loss, aux, peak memory under
   the card's.
19. tensor and data parallelism (after phase 17, in rank processes that end
   with the phase; Llama-2-7B at full width, random weights from phase 3's
   seed, each rank drawing them and keeping its shards): 19a one rank over
   NCCL, ``LLMEngine(mesh=make_mesh({"tensor": 1}))`` behind
   ``OpenAIServer``, phase 3's burst held as phase 3 queues it (its greedy
   and seeded rows equal to phase 3's tokens; the model's collectives
   counted on the one-wide group); 19b two ranks in two processes sharing
   the one card over gloo with CUDA tensors: each collective the path calls
   probed on CUDA tensors (a refused one staged through host tensors by the
   phase, and logged), prefill and one decode step's logits against the
   one-card port (cosine > 0.999, max rel err < 5e-2, greedy tokens by the
   top-2 margin rule), K1, K2, K3, K4 (folded) and K7 against their plain
   versions at the per-shard shapes, phase 3's burst through rank 0's
   server on the read-only and write-then-attend structures, bf16 and int8
   (weights and pages; the int8 model cut to depth 8 for time), with
   ``tp="2"`` on ``/metrics``, and the dense path at depth 4; 19c data-parallel LoRA (the 7B bf16 base on each rank, rank
   16 on the seven projections, B=1 a rank x S=512): the ``pmean``-ed
   adapter gradients against one rank's B=2 gradients (cosine >= 0.999 per
   target), then 1 + 2 ``Trainer`` steps, step ms and each rank's peak;
   19d ring and Ulysses attention over the two ranks (S = 2 x 2048, H 32, D
   128, causal and full) against K1 over the whole sequence, the ring's
   gradients (K5, K6) against the whole-sequence backward (within twice
   K5/K6's tolerance: each within it of the exact gradient); 19f
   full-parameter training through ``Trainer(param_specs=)`` on the same
   two ranks: (i) TP=2 on Llama-3.2-1B (bf16, full width and depth,
   ``llama.partition_specs``, B=2 x S=512), (ii) FSDP=2 on the same model
   and batch (``fsdp_specs``, one row a rank), (iii) TP=2 on Mixtral-8x7B's
   widths at depth 2 on the capacity experts (B=1 x S=512); each against
   the port's one-rank trainer run first in this process on the same seed
   (every leaf's gradient at cosine >= 0.999, the first loss within 1e-2,
   replicated leaves' gradients bitwise equal on both ranks, (ii)'s
   at-rest bytes <= 0.55 of one rank's), K1, K5 and K6 once a layer a step
   at the per-shard shapes and held against their plain versions there,
   step ms, peaks and collectives a step logged; 19e
   ``@clustered(size=1)`` with ``gpu="H100"``: one container joins an NCCL
   group of one and runs K1. No figure of 19b-19f is a multi-card speed:
   two ranks share one card.
20. C11's f32 flash instances and A11's models (after phase 16, before
   training, over phase 3's weights). (20a) K1-f32, K5-f32 and K6-f32
   (``csrc/flash_*_f32.cu``, on the tensor cores by the 3xTF32 split)
   against their plain versions at ``F32_CASES`` (GPT's default shape B=8,
   H=6, S=256, D=64; D=32 and 128; a ragged S=300, causal and not; GQA; a
   chunk at q_offset 496; a nonzero lse cotangent; the GPT sweep's D=16,
   zero-padded to 32) within ``F32_TOL`` of the largest value, each
   launched twice and bitwise equal, the check shown to refuse each kernel
   with its last tile dropped and with one TF32 pass (variants under
   ``build/variants``); the padding's cost at D=16 (the padded wrappers and
   backward, which pads once for both kernels, against the D=32 instance's
   at the sweep's shape).
   (20b) CLIP ViT-L/14 at 224 px (f32, random from a seed) and its
   projector in front of phase 3's Llama-2-7B bf16 weights: the tower
   against its CPU run (1e-4 of the largest value), an image request's
   prefill and first decode logits against the dense plain forward with
   ``input_embeds`` (the logit contract, the top-2 margin rule), then
   ``OpenAIServer`` with counters zeroed: two chat requests with PNG
   ``data:`` URIs (two images) beside five of phase 3's requests through
   ``/v1/completions`` (their rows phase 3's), then the first image again
   (``cached_tokens`` at least its image pages); K1, K2 and K3 launched,
   the two images' answers different, every page returned; the tower's ms,
   image and text TTFT, burst tok/s, peak GB. (20c) GPT at its default
   config (f32, 6 layers, dim 384, block 256, B=8): gradients through the
   f32 instances against ``attn_impl="xla"`` (cosine >= 0.9999 per leaf),
   1 + 2 ``Trainer`` steps (each f32 instance 6 a step), ``generate`` of 32
   tokens; C11 shown repaired: ``Trainer`` over an f32 Llama (head dim 64,
   8 layers) with rank-16 LoRA, B=2 x S=512, adapter gradients against xla
   (cosine >= 0.9999), 1 + 2 steps (8 launches of each a step). (20d) the
   detector, OCR (numpy lines: the card's machine has no PIL), SAM and the
   video DiT at their default configs: loss and gradients against the
   port's CPU run within 1e-4 of the largest value, one ``Trainer`` step
   each, ``video.sample`` with the first frame pinned. (20e) ``GRPOTrainer``
   at ``llama32_1b()`` width in bf16: group 8, a 32-token prompt, 8 new
   tokens, 1 + 2 steps; the first step's importance ratio 1 within 2^-7,
   the policy moved, the reference unchanged; step s and peak GB. The
   f32 instances' rows join the kernels line at GPT's default shape and,
   under ``at_shapes``, 20c's f32 Llama shape and that shape at S=1024 and
   2048 (``F32_TIMED``), with both
   operations bounds (f32 FMAs, three TF32 passes) and SDPA's
   memory-efficient f32 kernels as the library column.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_F32_FLOPS = 67e12  # H100 SXM dense f32 outside the tensor cores (data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
# bf16 tolerances against the plain versions (f32 math inside both):
# flash differs by the final bf16 rounding and summation order; decode also
# rounds unnormalised probabilities to bf16 where the plain version rounds
# normalised ones; the scatter is a copy. The flash backward kernels are held
# as max|grad - plain| / max|plain grad| (f32 math in both, one bf16 rounding
# of each gradient, sums in another order).
TOL = {"flash_fwd": 2e-2, "paged_decode": 6e-2, "kv_scatter": 0.0, "flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2,
       "quantized_matmul": 1e-3, "paged_decode_int8": 6e-2, "kv_scatter_int8": 0.0, "paged_decode_writeback": 1e-2,
       "paged_decode_writeback_differ": 1e-2, "paged_decode_row": 1e-2, "paged_decode_int8_row": 1e-2,
       "paged_decode_writeback_int8": 6e-2, "paged_decode_writeback_int8_row": 1e-2}
# the int8 matmul is held as max|out - plain| / max|plain|: its products are
# exact (int8 and bf16 values, f32 sums), only the summation order differs.
# The int8 decode has K2's numerics over the same dequantized values; the int8
# scatter must be bitwise (same IEEE divisions, round half to even). The
# write-then-attend decode keeps f32 probabilities as its plain version does,
# so the two differ only by f32 summation order before one bf16 rounding: it
# is held per (sequence, head) row as max|o - plain| / max|plain| (one bf16
# ulp is at most 2^-7 of the row's largest value) and by the share of output
# elements whose bf16 value differs from the plain version's ("_differ").
# Phase 2 shows that both limits see three planted faults: the last 64-row
# chunk of the longest context skipped, its last split dropped from the
# merge, and probabilities rounded to bf16 (K2's design, run on the same
# rows). K2, K2-int8 and K4-int8 (whose probabilities are rounded to bf16,
# as its JAX function's) are held the same way per (sequence, query head)
# row ("_row", beside the absolute limit), at contexts on both sides of the
# kernels' split edges, and phase 2 shows that check refusing two planted
# faults: the last page of the longest context dropped, and the last split
# of its rows dropped from the merge. The four decode kernels must also be
# bitwise equal from launch to launch (their merge runs in split order).
# (K, N) of every int8 weight of Llama-2-7B (wq/wk/wv/wo, gate/up, down,
# lm_head) and one ragged shape
QMM_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000), (4000, 11000)]
# training: adapter-gradient cosine between the flash and xla attention paths
GRAD_COSINE_MIN = 0.999
# K1 against its plain version: (B, Hq, Hkv, S, Skv, q_offset, causal, D)
K1_CASES = [
    (4, 32, 32, 512, 512, 0, True, 128),      # the engine's prefill batch
    (1, 32, 32, 512, 1024, 512, True, 128),   # a prompt chunk at a tile boundary
    (4, 32, 8, 512, 512, 0, True, 128),       # GQA
    (2, 8, 2, 300, 300, 0, True, 128),        # ragged S
    (2, 8, 2, 300, 300, 0, False, 128),       # ragged, full attention
    (1, 32, 32, 204, 700, 496, True, 128),    # q_offset a multiple of 16, not of the tile; ragged Skv
    (2, 8, 2, 300, 300, 0, True, 64),         # other head dims
    (2, 4, 2, 200, 200, 0, True, 256),
    (2, 8, 2, 300, 300, 0, True, 80),         # a head dim between instances: zero-padded to 128
]
# instructions each library's SASS must hold: the products on wgmma (HGMMA)
# fed by TMA (UTMALDG); the int4 matmul's prefill path on wgmma and TMA, its
# decode ring on TMA and mma.sync (HMMA), its masked path on mma.sync; the
# three f32 instances on tf32 wgmma, fed by TMA; the four decode kernels'
# rows streamed by cp.async (LDGSTS)
SASS_CHECKED = {
    **{name: ("HGMMA", "UTMALDG") for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "quantized_matmul",
                                               "flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")},
    "quantized_matmul_int4": ("HGMMA", "UTMALDG", "HMMA"),
    **{name: ("LDGSTS",) for name in ("paged_decode", "paged_decode_int8", "paged_decode_writeback",
                                      "paged_decode_writeback_int8")},
}
# phase 5 cycles the decode kernels over these layers of one cache: their
# rows (141 MB bf16, 71 MB int8) exceed the 50 MB L2, so each launch reads
# from HBM as a decode step's 32 layers do
CYCLED_LAYERS = (5, 6, 7, 8)
# K7's paths (``quantized_matmul.kernel_path``): every weight shape of the
# model must take the TMA ones, "ring" at M <= 64 and "wgmma" above
QMM_MS = (1, 8, 64, 65, 300, 2048)


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_spin_cycles_per_ms: list = []


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card, timed
    once by CUDA events."""
    if not _spin_cycles_per_ms:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _spin_cycles_per_ms.append(10_000_000 / start.elapsed_time(end))
    return _spin_cycles_per_ms[0]


def device_ms(fn, n: int = 40, tries: int = 4) -> float | None:
    """Device time of a call of ``fn`` (every kernel it launches and the
    card's own gaps between them; none of the host's time): after 3 warm-up
    calls, ``n`` calls queued behind a spin kernel (``torch.cuda._sleep``)
    long enough for the host to enqueue them all, timed between two CUDA
    events. A try in which the card reached the first event before the host
    had enqueued the last call (the host may then have set the pace) is
    taken again with four times the spin; None (not measured) after
    ``tries``. No ``torch.profiler`` here: late in a long process it loses
    kernel events and hands some to later windows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 1.0  # twice the host's time to enqueue n calls
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        spin_ms *= 4
    log(f"device_ms: the card caught up with the host in {tries} tries (last spin {spin_ms / 4:.1f} ms): "
        f"not measured")
    return None


def fmt_ms(ms: float | None) -> str:
    """A reading for a log line: 4 decimals, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


def back_to_back_ms(fn, n: int = 50) -> float:
    """Per-launch ms of ``n`` launches between two events, after 3 warm-up
    launches: the kernel's own time once the host enqueues faster than the
    card runs (a single launch between its own events also times the
    wrapper's host work whenever that is longer)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def sdpa(q, k, v, causal: bool):
    """PyTorch's attention on the same inputs: a yardstick, never the port's path."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel instance of an ``-Xptxas -v`` report: the entry's
    name (the kernel and its template arguments, from the mangled symbol),
    its registers and its spills; and any line where ptxas says it
    serialized wgmma instructions."""
    def demangle(symbol: str) -> str:  # the last name of a (nested) mangled symbol and its integer arguments
        i, last, args = symbol.find("N") + 1 if symbol.startswith("_ZN") else 2, symbol, ""
        while i < len(symbol) and symbol[i].isdigit():
            j = i
            while symbol[j].isdigit():
                j += 1
            n = int(symbol[i:j])
            last, i = symbol[j:j + n], j + n
        if symbol[i:i + 1] == "I":
            args = "<" + ", ".join(re.findall(r"L[a-z](\d+)E", symbol[i:symbol.find("EE", i) + 1])) + ">"
        return last + args

    out, name = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spills = demangle(entry.group(1)), "spills not reported"
        elif "spill" in line and name:
            spills = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {re.search(r'Used \d+ registers', line).group(0)}, {spills}")
            name = None
        elif "C7513" in line:
            out.append(line.strip())
    return out


def check_sass(_build) -> None:
    """Logs the counts of each library's ``SASS_CHECKED`` instructions, read
    with ``cuobjdump -sass``; raises if a library has none of one."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    counts = {}
    for name, ops in SASS_CHECKED.items():
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                              check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    log(f"SASS instruction counts: {counts}")
    if not all(n > 0 for c in counts.values() for n in c.values()):
        raise AssertionError(f"a kernel lacks a checked instruction in its SASS: {counts}")


# -- phase 2 inputs ---------------------------------------------------------------


def rand_bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)


def flash_case(gen, B, Hq, Hkv, S, Skv, D=128):
    return rand_bf16(gen, B, Hq, S, D), rand_bf16(gen, B, Hkv, Skv, D), rand_bf16(gen, B, Hkv, Skv, D)


def int8_pages(gen, *shape):
    """A random int8 cache: int8 rows and positive f32 scales."""
    from modal_examples_tpu_torch.ops.kv_quant import QuantizedKV

    return QuantizedKV(
        data=torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
        scale=torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 1e-3,
    )


DECODE_LENS = (0, 1, 15, 16, 17, 333, 777, 1000)


def decode_split_rows() -> int:
    """SPLIT of ``csrc/paged_decode.cuh``: the cached rows one block of the
    ragged decode kernels takes."""
    src = (ROOT / "modal_examples_tpu_torch" / "csrc" / "paged_decode.cuh").read_text()
    return int(re.search(r"constexpr int SPLIT = (\d+);", src).group(1))


def split_edge_lens(split: int) -> tuple:
    """Prefixes on both sides of the decode kernels' split edges, one below
    the 64 x 16-row table and the full table."""
    return (split - 1, split, split + 1, 2 * split, 2 * split + 1, 3 * split - 1, 1023, 1024)


def decode_case(gen, B, Hq, Hkv, L, D=128, ps=16, pps=64, int8=False, lens=DECODE_LENS):
    """Ragged prefix lengths (default 0..1000) over shuffled pages of the
    full cache (bf16 pages, or int8 pages with their scales)."""
    P = 1 + B * pps
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[: B * pps] + 1
    lens = torch.tensor(lens[:B], dtype=torch.int32)
    pages = int8_pages if int8 else rand_bf16
    return dict(
        q=rand_bf16(gen, B, Hq, D),
        k_pages=pages(gen, L, P, ps, Hkv, D),
        v_pages=pages(gen, L, P, ps, Hkv, D),
        page_tables=perm.reshape(B, pps).to(torch.int32).cuda(),
        prefix_lens=lens.cuda(),
        k_new=rand_bf16(gen, B, Hkv, D),
        v_new=rand_bf16(gen, B, Hkv, D),
    )


def writeback_case(gen, B, Hq, Hkv, L, ctx, D=128, ps=16, pps=64, int8=False, dead=True):
    """One layer's pages (the contiguous view ``pages[2]`` of a bf16 cache,
    or of an int8 one) for contexts ``ctx`` that count the current token,
    over shuffled pages; with ``dead`` the last slot is dead: its table is
    all trash page 0."""
    P = 1 + B * pps
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[: B * pps] + 1
    tables = perm.reshape(B, pps).to(torch.int32)
    if dead:
        tables[-1] = 0
    pages = int8_pages if int8 else rand_bf16
    k_cache, v_cache = pages(gen, L, P, ps, Hkv, D), pages(gen, L, P, ps, Hkv, D)
    return dict(
        q=rand_bf16(gen, B, Hq, D), k_pages=k_cache[2], v_pages=v_cache[2],
        page_tables=tables.cuda(), context_lens=torch.tensor(ctx, dtype=torch.int32).cuda(),
        k_cache=k_cache, v_cache=v_cache,
    )


def decode_args(c, layer: int) -> list:
    return [c["q"], c["k_pages"], c["v_pages"], layer, c["page_tables"], c["prefix_lens"], c["k_new"], c["v_new"]]


def check_decode(name: str, kernel, plain, c, label: str) -> float:
    """K2 or K2-int8 (``kernel``) on one ``decode_case`` at layer 2 against
    its plain version, per (sequence, query head) row and by max abs; two
    launches must be bitwise equal; two planted faults, run through the plain
    version on the same rows, must read above the row limit. Returns the max
    abs error."""
    args = decode_args(c, 2)
    o = kernel(*args, sm_scale=128**-0.5)
    again = kernel(*args, sm_scale=128**-0.5)
    torch.cuda.synchronize()
    want = plain(*args, sm_scale=128**-0.5)
    lens = c["prefix_lens"]
    ctx = lens + 1  # every row attends at least to the in-flight token
    got = writeback_readings(o, want, ctx)
    log(f"{label} prefixes {lens.tolist()}: max|o-plain|={got['max_abs']:.3g}, row max|o-plain|/max|plain|="
        f"{got['row_rel']:.3g}, elements differing {got['differ']:.3g}, bitwise equal on a second launch "
        f"{torch.equal(o, again)}")
    longest = int(lens.argmax())
    n, ps, split = int(lens[longest]), c["k_pages"].shape[2], decode_split_rows()
    for fault, cut in ((f"last page of prefix {n} dropped", (n - 1) // ps * ps),
                       (f"last split of prefix {n} dropped from the combine", (n - 1) // split * split)):
        short = lens.clone()
        short[longest] = cut
        bad = writeback_readings(plain(*args[:5], short, *args[6:], sm_scale=128**-0.5), want, ctx)
        log(f"  planted fault, {fault}: max|o-plain|={bad['max_abs']:.3g}, row {bad['row_rel']:.3g}")
        if bad["row_rel"] <= TOL[f"{name}_row"]:
            raise AssertionError(f"the {name} check does not see a planted fault ({fault}): {bad}")
    if not (got["max_abs"] <= TOL[name] and got["row_rel"] <= TOL[f"{name}_row"]):
        raise AssertionError(f"{name} kernel disagrees with its plain version: {got}")
    if not torch.equal(o, again):
        raise AssertionError(f"{name} differs from run to run")
    return got["max_abs"]


def decode_cases(gen, int8: bool):
    """(label, case) of phase 2's decode checks: 8 slots at G = 1 and 4, at
    the default prefixes and at the split edges."""
    for lens in (DECODE_LENS, split_edge_lens(decode_split_rows())):
        for Hkv in (32, 8):
            yield (f"K2{'-int8' if int8 else ''} decode B=8 Hq=32 Hkv={Hkv} layer=2",
                   decode_case(gen, 8, 32, Hkv, L=4, int8=int8, lens=lens))


WRITEBACK_ARGS = ("q", "k_pages", "v_pages", "page_tables", "context_lens")


def writeback_readings(o, want, ctx) -> dict:
    """The K4 check's readings over the (sequence, head) rows that have a
    context: the largest max|o - want| / max|want| of a row, and the share of
    their elements whose bf16 value differs from ``want``'s (and max abs)."""
    live = torch.as_tensor(ctx, device=o.device) > 0
    o, want = o[live].float(), want[live].float()
    row = (o - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)
    return {"row_rel": row.max().item(), "differ": (o != want).float().mean().item(), "max_abs": max_err(o, want)}


def longest_context(c) -> tuple:
    """(slot, rows) of the longest context of a ``writeback_case``, its rows
    cut to the table (the kernels read no further)."""
    lens = c["context_lens"]
    longest = int(lens.argmax())
    return longest, min(int(lens[longest]), c["page_tables"].shape[1] * c["k_pages"].shape[1])


def writeback_faults(pa, c, int8: bool) -> dict:
    """Planted faults on the same inputs, each a wrong K4 or K4-int8 that the
    check must refuse: the plain version with the longest context's last
    split dropped from the merge, and with its last 64-row chunk skipped
    (K4) or its last page dropped (K4-int8); for K4 also K2, which rounds its
    probabilities to bf16, over the same rows (the prefix is the context less
    its last row, which goes in as the in-flight token)."""
    plain = pa.paged_decode_writeback_int8_plain if int8 else pa.paged_decode_writeback_plain
    args = [c[n] for n in WRITEBACK_ARGS]
    longest, n = longest_context(c)
    ps, split = c["k_pages"].shape[1], decode_split_rows()
    cuts = {f"last split of context {n} dropped from the merge": (n - 1) // split * split}
    if int8:
        cuts[f"last page of context {n} dropped"] = (n - 1) // ps * ps
    else:
        cuts[f"last 64-row chunk of context {n} skipped"] = (n - 1) // 64 * 64
    faults = {}
    for fault, cut in cuts.items():
        short = c["context_lens"].clone()
        short[longest] = cut
        faults[fault] = plain(*args[:4], short, sm_scale=128**-0.5)
    if not int8:
        B = len(c["context_lens"])
        last = (c["context_lens"].long() - 1).clamp(min=0)
        page = c["page_tables"].long()[torch.arange(B, device="cuda"), last // ps]
        k_new, v_new = c["k_pages"][page, last % ps], c["v_pages"][page, last % ps]
        faults["probabilities rounded to bf16 (K2)"] = pa.paged_decode_cuda(
            c["q"], c["k_cache"], c["v_cache"], 2, c["page_tables"], last.int(), k_new, v_new, sm_scale=128**-0.5)
    return faults


def writeback_passes(name: str, r: dict) -> bool:
    """The K4 check (row and share of differing elements) or the K4-int8
    check (row and max abs) on ``writeback_readings``."""
    if name == "paged_decode_writeback":
        return r["row_rel"] <= TOL[name] and r["differ"] <= TOL[f"{name}_differ"]
    return r["row_rel"] <= TOL[f"{name}_row"] and r["max_abs"] <= TOL[name]


def check_writeback(pa, name: str, c, label: str) -> float:
    """K4 or K4-int8 (``name``: the wrapper ``pa.<name>_cuda``) on one
    ``writeback_case`` against its plain version (``writeback_passes``),
    empty contexts exactly zero, two launches bitwise equal, and every
    planted fault of ``writeback_faults`` refused by the same check. Returns
    the max abs error."""
    kernel, plain = getattr(pa, f"{name}_cuda"), getattr(pa, f"{name}_plain")
    args = [c[n] for n in WRITEBACK_ARGS]
    o = kernel(*args, sm_scale=128**-0.5)
    again = kernel(*args, sm_scale=128**-0.5)
    torch.cuda.synchronize()
    want = plain(*args, sm_scale=128**-0.5)
    ctx = c["context_lens"]
    got = writeback_readings(o, want, ctx)
    empty = o[ctx == 0]
    log(f"{label}, contexts {ctx.tolist()}: max|o-plain|={got['max_abs']:.3g}, row max|o-plain|/max|plain|="
        f"{got['row_rel']:.3g}, elements differing {got['differ']:.3g}, max|o| of the {len(empty)} empty contexts "
        f"{empty.abs().max().item() if len(empty) else None}, bitwise equal on a second launch {torch.equal(o, again)}")
    for fault, wrong in writeback_faults(pa, c, name.endswith("int8")).items():
        bad = writeback_readings(wrong, want, ctx)
        log(f"  planted fault, {fault}: max|o-plain|={bad['max_abs']:.3g}, row {bad['row_rel']:.3g}, "
            f"elements differing {bad['differ']:.3g}")
        if writeback_passes(name, bad):
            raise AssertionError(f"the {name} check does not see a planted fault ({fault}): {bad}")
    if not writeback_passes(name, got):
        raise AssertionError(f"{name} kernel disagrees with its plain version: {got}")
    if len(empty) and empty.abs().max().item() != 0.0:
        raise AssertionError(f"{name} gives nonzero output for an empty context")
    if not torch.equal(o, again):
        raise AssertionError(f"{name} differs from run to run")
    return got["max_abs"]


# contexts 1, a page, a page plus one, 1001; none (zeros); a mix; a dead slot
WRITEBACK_CTX = (1, 16, 17, 1001, 0, 334, 512, 1)


def writeback_cases(gen, int8: bool):
    """(label, case) of phase 2's write-then-attend checks: 8 slots at G = 1
    and 4 over layer 2's pages, at ``WRITEBACK_CTX`` (the last slot dead, on
    trash page 0) and at contexts on both sides of the split edges (each a
    prefix of ``split_edge_lens`` plus the current token, cut to the
    64 x 16-row table)."""
    edges = tuple(min(n + 1, 64 * 16) for n in split_edge_lens(decode_split_rows()))
    for ctx, dead in ((WRITEBACK_CTX, True), (edges, False)):
        for Hkv in (32, 8):
            yield (f"K4{'-int8' if int8 else ''} writeback decode B=8 Hq=32 Hkv={Hkv} one layer's pages",
                   writeback_case(gen, 8, 32, Hkv, L=4, ctx=ctx, int8=int8, dead=dead))


# -- the folded write: K4 writing the new rows itself ---------------------------------

#: the writer block of the folded write in ``csrc/paged_decode.cuh``, and
#: the planted fault built from it: the row handed to the split after the
#: one that holds its position (an empty split, which exits at once)
FOLD_WRITER = "const int writer = max(n_used - 1, 0);"
FOLD_WRONG_WRITER = "const int writer = n_used;"


def fold_decode_case(gen, Hkv: int, ctx, dead: tuple) -> dict:
    """A decode step of one layer through the folded write: ``writeback_case``
    plus each slot's new K/V rows, written where its context's last row
    sits. The slots in ``dead`` are dead: they write trash page 0, slot 0
    with equal rows, so that race has one result (as ``scatter_case``'s
    dead tokens), and attend their one row (or none) through their table,
    all trash for the last slot when it is among them, a stale one for the
    others."""
    B, ps = len(ctx), 16
    c = writeback_case(gen, B, 32, Hkv, L=4, ctx=ctx, dead=B - 1 in dead)
    dead_mask = torch.zeros(B, dtype=torch.bool, device="cuda")
    dead_mask[list(dead)] = True
    pos = (c["context_lens"] - 1).clamp(min=0).long()
    page = c["page_tables"].gather(1, (pos // ps)[:, None])[:, 0]
    k_new, v_new = rand_bf16(gen, B, Hkv, 128), rand_bf16(gen, B, Hkv, 128)
    if dead:
        k_new[dead_mask], v_new[dead_mask] = k_new[dead[0]].clone(), v_new[dead[0]].clone()
    c.update(k_new=k_new, v_new=v_new,
             page_idx=torch.where(dead_mask, 0, page).int(), slot=torch.where(dead_mask, 0, pos % ps).int(),
             positions=None, chain=1, trash_writers=int(dead_mask.sum()))
    return c


def fold_verify_case(gen, Hkv: int, pos0) -> dict:
    """A verify step's rows through the folded write: chains of
    ``VERIFY_T`` from ``pos0`` over one layer's pages (64 x 16 rows), each
    chain row a query row, its table repeated; rows past the table's
    capacity write trash page 0, slot 0 (``llama.verify_step``'s targets)."""
    B, T, ps, pps = len(pos0), VERIFY_T, 16, 64
    c = writeback_case(gen, B, 32, Hkv, L=4, ctx=[1] * B, dead=False)
    cap = pps * ps
    positions = torch.tensor(pos0, device="cuda")[:, None] + torch.arange(T, device="cuda")[None]
    valid = positions < cap
    pc = positions.clamp(max=cap - 1)
    page = c["page_tables"].long().gather(1, pc // ps)
    rows = B * T
    c.update(q=rand_bf16(gen, rows, 32, 128), page_tables=c["page_tables"].repeat_interleave(T, 0),
             context_lens=(positions + 1).clamp(max=cap).reshape(rows).int(),
             k_new=rand_bf16(gen, rows, Hkv, 128), v_new=rand_bf16(gen, rows, Hkv, 128),
             page_idx=torch.where(valid, page, 0).reshape(rows).int(),
             slot=torch.where(valid, pc % ps, 0).reshape(rows).int(),
             positions=positions.reshape(rows).int(), chain=T, trash_writers=int((~valid).sum()))
    return c


FOLD_NEW = ("k_new", "v_new", "page_idx", "slot", "positions", "chain")


def fold_sequence(pa, c) -> tuple:
    """K3 over the one-layer view, then K4: the pages and output of the
    sequence the folded write replaces, from fresh copies of the pages."""
    kp, vp = c["k_pages"].clone(), c["v_pages"].clone()
    pa.scatter_kv_layer(kp, vp, c["k_new"], c["v_new"], c["page_idx"], c["slot"])
    o = pa.paged_decode_writeback_cuda(c["q"], kp, vp, c["page_tables"], c["context_lens"], sm_scale=128**-0.5)
    return kp, vp, o


def fold_launch(pa, c, **changed) -> tuple:
    """One folded launch on fresh copies of the pages: (pages, output)."""
    kp, vp = c["k_pages"].clone(), c["v_pages"].clone()
    new = {n: changed.get(n, c[n]) for n in FOLD_NEW}
    o = pa.paged_decode_writeback_cuda(c["q"], kp, vp, c["page_tables"], c["context_lens"], sm_scale=128**-0.5,
                                       **new)
    return kp, vp, o


def fold_differs(got: tuple, want: tuple, c) -> dict:
    """Where a folded launch differs from K3 -> K4: pages (trash page 0's
    row 0 left out where several rows race for it with different values,
    and then each of its elements required to be one of theirs: the
    writers' 16-byte stores interleave) and output, bitwise."""
    pages = []
    for g, w in zip(got[:2], want[:2]):
        if c["trash_writers"] > 1 and not torch.equal(g[0, 0], w[0, 0]):
            new = c["k_new"] if g is got[0] else c["v_new"]
            writers = new[(c["page_idx"] == 0) & (c["slot"] == 0)]
            pages.append(not bool((writers == g[0, 0][None]).any(dim=0).all())
                         or not torch.equal(g[1:], w[1:]) or not torch.equal(g[0, 1:], w[0, 1:]))
        else:
            pages.append(not torch.equal(g, w))
    rows = (got[2] != want[2]).flatten(1).any(dim=1)
    return {"pages": any(pages), "rows_differing": int(rows.sum()), "output": bool(rows.any())}


def build_variant(tag: str, name: str, path: str, old: str, new: str):
    """``csrc/<name>.cu``'s library built from a copy of ``csrc`` with one
    line of ``path`` changed (``old`` must occur once): a planted fault,
    under ``build/variants/<tag>``."""
    return build_variants(tag, [name], {path: (old, new)})[name]


def fold_cases(gen):
    """(label, case) of phase 2's folded-write checks: decode steps at
    ``WRITEBACK_CTX`` (slot 0 dead on its stale table, slot 4's empty
    context dead, the last slot dead on an all-trash table) and at the split
    edges, G = 1
    and 4; verify chains from prefixes on both sides of the split edges, at
    page starts and past the table's end."""
    split = decode_split_rows()
    edges = tuple(min(n + 1, 64 * 16) for n in split_edge_lens(split))
    for Hkv in (32, 8):
        yield (f"K4 folded decode Hkv={Hkv}, contexts {WRITEBACK_CTX}",
               fold_decode_case(gen, Hkv, WRITEBACK_CTX, (0, 4, len(WRITEBACK_CTX) - 1)))
        yield f"K4 folded decode Hkv={Hkv}, contexts {edges}", fold_decode_case(gen, Hkv, edges, ())
    pos0 = (split - 2, split - 4, 2 * split - 1, 16, 0, 333, 64 * 16 - 3, 64 * 16 - 1)
    yield f"K4 folded verify 8 x T={VERIFY_T} from {pos0}", fold_verify_case(gen, 8, pos0)


def check_folds(pa, gen) -> float:
    """Phase 2's folded write: for each of ``fold_cases``, the folded K4
    against K3 -> K4 on the same inputs, pages and output bitwise (two
    folded launches), and against its plain twin at K4's limits
    (``writeback_passes``); then two planted faults that the bitwise check
    must refuse: the longest context's write skipped (its row sent to the
    trash page, so nothing writes or stages it: the stale row is read), and
    the row written by the wrong split's block (a variant of the kernel,
    ``FOLD_WRONG_WRITER``: the row never lands). Returns the largest max abs
    error against the plain twin."""
    from modal_examples_tpu_torch.ops import _build

    variant = build_variant("fold-wrong-writer", "paged_decode_writeback", "paged_decode.cuh", FOLD_WRITER,
                            FOLD_WRONG_WRITER)
    worst = 0.0
    for label, c in fold_cases(gen):
        want = fold_sequence(pa, c)
        got, again = fold_launch(pa, c), fold_launch(pa, c)
        torch.cuda.synchronize()
        diff, diff2 = fold_differs(got, want, c), fold_differs(again, want, c)
        kq, vq = c["k_pages"].clone(), c["v_pages"].clone()
        plain = pa.paged_decode_writeback_plain(c["q"], kq, vq, c["page_tables"], c["context_lens"],
                                                sm_scale=128**-0.5, **{n: c[n] for n in FOLD_NEW})
        vs_plain = writeback_readings(got[2], plain, c["context_lens"])
        longest = int(torch.where(c["page_idx"] > 0, c["context_lens"], -1).argmax())
        to_trash = torch.tensor([longest], device="cuda")
        skipped = fold_differs(fold_launch(pa, c, page_idx=c["page_idx"].index_fill(0, to_trash, 0),
                                           slot=c["slot"].index_fill(0, to_trash, 0)), want, c)
        _build._libs["paged_decode_writeback"], this = variant, _build._libs["paged_decode_writeback"]
        try:
            wrong = fold_differs(fold_launch(pa, c), want, c)
        finally:
            _build._libs["paged_decode_writeback"] = this
        log(f"{label}: against K3 -> K4 {diff} (again {diff2}); against the plain twin {vs_plain}; planted "
            f"faults: write of row {longest} skipped {skipped}, written by the wrong split's block {wrong}")
        if diff["pages"] or diff["output"] or diff2["pages"] or diff2["output"]:
            raise AssertionError(f"{label}: the folded write is not bitwise K3 -> K4: {diff}, {diff2}")
        if not writeback_passes("paged_decode_writeback", vs_plain):
            raise AssertionError(f"{label}: the folded write disagrees with its plain twin: {vs_plain}")
        if not (skipped["output"] and skipped["pages"]):
            raise AssertionError(f"{label}: the check does not see a skipped write (stale row read): {skipped}")
        if not wrong["pages"]:
            raise AssertionError(f"{label}: the check does not see the row written by the wrong block: {wrong}")
        worst = max(worst, vs_plain["max_abs"])
    return worst


def scatter_case(gen, L, N, P, Hkv=32, D=128, ps=16, seed=2, dead=True):
    """N tokens on distinct targets (drawn from ``seed``); with ``dead``, two
    of them are dead on trash page 0 slot 0 (given equal rows, so the race
    has one possible result)."""
    k_all, v_all = rand_bf16(gen, L, N, Hkv, D), rand_bf16(gen, L, N, Hkv, D)
    flat = torch.randperm((P - 1) * ps, generator=torch.Generator().manual_seed(seed))[:N] + ps
    page_idx, slot = (flat // ps).to(torch.int32), (flat % ps).to(torch.int32)
    if dead:
        page_idx[[1, 3]] = 0
        slot[[1, 3]] = 0
        k_all[:, 3], v_all[:, 3] = k_all[:, 1], v_all[:, 1]
    return k_all, v_all, page_idx.cuda(), slot.cuda()


# K3 and K3-int8 in phase 5 and in benchmarks_torch/kernel_ab.py, (L, N) at
# Hkv=32, D=128 into a cache of 513 pages of 16: a decode step's 8 tokens x
# 32 layers, the prefill batch's 4 x 512 tokens x 32 layers, and the
# write-then-attend path's one layer's view (8 tokens, ``scatter_kv_layer``)
SCATTER_SHAPES = {"decode": (32, 8), "prefill": (32, 2048), "one layer": (1, 8)}
SCATTER_SETS = 32  # decode shape: sets of rows and targets cycled, 134 MB of bf16 rows


def scatter_bytes(L: int, N: int, int8: bool, Hkv: int = 32, D: int = 128) -> int:
    """Bytes a scatter of N tokens x L layers must move: the bf16 K and V
    rows read once, written once as bf16 (K3) or as int8 rows with one f32
    scale each (K3-int8)."""
    rows = 2 * L * N * Hkv
    return rows * 2 * D + rows * (D + 4 if int8 else 2 * D)


def copy_pages(dst, src) -> None:
    for a, b in ((dst.data, src.data), (dst.scale, src.scale)) if hasattr(src, "scale") else ((dst, src),):
        a.copy_(b)


def clone_pages(pages):
    from modal_examples_tpu_torch.ops.kv_quant import QuantizedKV

    return QuantizedKV(pages.data.clone(), pages.scale.clone()) if hasattr(pages, "scale") else pages.clone()


def pages_err(got, want) -> float:
    """0.0 where two caches (bf16, or int8 data and f32 scales) are bitwise
    equal, else their largest difference (inf if that reads 0)."""
    pairs = [(got.data, want.data), (got.scale, want.scale)] if hasattr(want, "scale") else [(got, want)]
    if all(torch.equal(a, b) for a, b in pairs):
        return 0.0
    return max(max_err(a, b) for a, b in pairs) or math.inf


def scatter_timed(pa, gen, shape: str, int8: bool) -> dict:
    """K3 or K3-int8 at one of ``SCATTER_SHAPES``, through the wrappers a
    caller uses: ``launch`` cycles the kernel over ``SCATTER_SETS`` sets of
    rows and targets at the decode shape (their rows exceed the 50 MB L2, so
    they are read from HBM as the bound counts them), over the 32 layers of
    one cache (each with its own rows, as a step's 32 launches) at the one
    layer shape; ``check()`` restores the cache, launches the first of
    them and returns ``pages_err`` against the plain version; ``plain`` is
    the plain version of that launch; ``nbytes`` is one launch's bytes;
    ``pages`` the cache and ``sets`` the rows and targets of each launch
    (none at the one-layer shape)."""
    L, N = SCATTER_SHAPES[shape]
    cache_layers, P = 32, 513
    pages = int8_pages if int8 else rand_bf16
    kp, vp = pages(gen, cache_layers, P, 16, 32, 128), pages(gen, cache_layers, P, 16, 32, 128)
    plain = pa.scatter_int8_plain if int8 else pa.scatter_plain
    if shape == "one layer":
        k_all, v_all, page_idx, slot = scatter_case(gen, cache_layers, N, P)
        calls = [(lambda li=li: pa.scatter_kv_layer(kp[li], vp[li], k_all[li], v_all[li], page_idx, slot))
                 for li in range(cache_layers)]

        def plain_first(k, v):
            return plain(k[0:1], v[0:1], k_all[0:1], v_all[0:1], page_idx.long(), slot.long())
    else:
        sets = [scatter_case(gen, L, N, P, seed=2 + i) for i in range(SCATTER_SETS if shape == "decode" else 1)]
        # the wrapper is looked up at each call, so a benchmark may swap it
        name = "scatter_int8_cuda" if int8 else "scatter_cuda"
        calls = [(lambda s=s: getattr(pa, name)(kp, vp, *s)) for s in sets]

        def plain_first(k, v):
            k_all, v_all, page_idx, slot = sets[0]
            return plain(k, v, k_all, v_all, page_idx.long(), slot.long())
    orig = (clone_pages(kp), clone_pages(vp))
    want = (clone_pages(kp), clone_pages(vp))
    plain_first(*want)

    def check() -> float:
        copy_pages(kp, orig[0])
        copy_pages(vp, orig[1])
        calls[0]()
        torch.cuda.synchronize()
        return max(pages_err(kp, want[0]), pages_err(vp, want[1]))

    return dict(launch=cycling(calls), check=check, plain=lambda: plain_first(kp, vp),
                nbytes=scatter_bytes(L, N, int8), pages=(kp, vp), sets=None if shape == "one layer" else sets)


def phase_kernels_vs_plain(fa, pa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for B, Hq, Hkv, S, Skv, off, causal, D in K1_CASES:
        q, k, v = flash_case(gen, B, Hq, Hkv, S, Skv, D)
        o, lse = fa.flash_forward_cuda(q, k, v, causal=causal, sm_scale=D**-0.5, q_offset=off)
        torch.cuda.synchronize()
        o2, lse2 = fa.flash_forward_plain(q, k, v, causal=causal, sm_scale=D**-0.5, q_offset=off)
        e, e_lse = max_err(o, o2), max_err(lse, lse2)
        # PyTorch's flash kernel on the same inputs also rounds P to bf16: its
        # reading is logged beside the kernel's, not held to a limit
        lib = "" if off else (f", SDPA max|o-plain|={max_err(sdpa(q, k, v, causal), o2):.3g}")
        log(f"K1 flash B={B} Hq={Hq} Hkv={Hkv} S={S} Skv={Skv} q_offset={off} causal={causal} D={D}: "
            f"max|o-plain|={e:.3g} max|lse-plain|={e_lse:.3g}{lib}")
        if not (e <= TOL["flash_fwd"] and e_lse <= 1e-3):
            raise AssertionError(f"flash kernel disagrees with its plain version: {e}, {e_lse}")
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), e)
    for label, c in decode_cases(gen, int8=False):
        e = check_decode("paged_decode", pa.paged_decode_cuda, pa.paged_decode_plain, c, label)
        errs["paged_decode"] = max(errs.get("paged_decode", 0.0), e)
        del c
    for label, c in writeback_cases(gen, int8=False):
        e = check_writeback(pa, "paged_decode_writeback", c, label)
        errs["paged_decode_writeback"] = max(errs.get("paged_decode_writeback", 0.0), e)
        del c
    errs["paged_decode_writeback_folded"] = check_folds(pa, gen)
    for L, N, P in [(32, 8, 513), (32, 2048, 513)]:  # decode step; prefill batch 4 x 512
        k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P)
        kp, vp = rand_bf16(gen, L, P, 16, 32, 128), rand_bf16(gen, L, P, 16, 32, 128)
        kq, vq = kp.clone(), vp.clone()
        pa.scatter_cuda(kp, vp, k_all, v_all, page_idx, slot)
        torch.cuda.synchronize()
        pa.scatter_plain(kq, vq, k_all, v_all, page_idx.long(), slot.long())
        e = max(max_err(kp, kq), max_err(vp, vq))
        log(f"K3 scatter L={L} N={N} P={P}: max|pages-plain|={e}")
        if e != 0.0:
            raise AssertionError(f"scatter kernel is not bitwise equal to its plain version: {e}")
        errs["kv_scatter"] = e
        del kp, vp, kq, vq
    return errs


def bwd_case(fa, gen, B, Hq, Hkv, S, causal, nonzero_dlse, D=128):
    """Inputs of the two backward kernels: q/k/v/dO bf16, and lse from the
    forward kernel, delta = rowsum(dO*O), dlse f32."""
    q, k, v = flash_case(gen, B, Hq, Hkv, S, S, D)
    do = rand_bf16(gen, B, Hq, S, D)
    o, lse = fa.flash_forward_cuda(q, k, v, causal=causal, sm_scale=D**-0.5)
    dlse = (torch.randn(B, Hq, S, generator=gen, device="cuda") if nonzero_dlse
            else torch.zeros(B, Hq, S, device="cuda"))
    delta = (do.float() * o.float()).sum(dim=-1)
    return (q, k, v, do, lse, delta, dlse), o


def rel_err(a, b) -> float:
    return max_err(a, b) / b.float().abs().max().item()


def phase_backward_vs_plain(fa, errs: dict) -> bool:
    """dQ and dK/dV kernels against flash_backward_plain on the same inputs,
    each launched twice. Returns whether every second launch equalled the
    first, bitwise (phase 14b's loss tolerance follows from it)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (B, Hq, Hkv, S, causal, nonzero dlse, D)
        (2, 32, 32, 512, True, False, 128),   # the training path's shape (MHA)
        (2, 32, 8, 512, True, False, 128),    # GQA
        (2, 32, 32, 512, False, False, 128),  # non-causal
        (2, 8, 2, 300, True, False, 128),     # ragged S
        (2, 32, 32, 512, True, True, 128),    # lse cotangent
        (2, 8, 2, 300, True, False, 64),      # other head dims
        (2, 8, 2, 300, True, False, 32),
        (2, 4, 2, 200, True, False, 256),
        (2, 4, 2, 200, False, True, 256),
        (2, 8, 2, 300, True, True, 80),       # a head dim between instances: zero-padded to 128
        (DREAMBOOTH_B, 24, 24, 1178, False, False, 64),  # the MMDiT's joint attention in DreamBooth (17d)
    ]
    bitwise = True
    for B, Hq, Hkv, S, causal, nz, D in cases:
        args, o = bwd_case(fa, gen, B, Hq, Hkv, S, causal, nz, D)
        dq = fa.flash_bwd_dq_cuda(*args, causal=causal, sm_scale=D**-0.5)
        dk, dv = fa.flash_bwd_dkv_cuda(*args, causal=causal, sm_scale=D**-0.5)
        again = (fa.flash_bwd_dq_cuda(*args, causal=causal, sm_scale=D**-0.5),
                 *fa.flash_bwd_dkv_cuda(*args, causal=causal, sm_scale=D**-0.5))
        torch.cuda.synchronize()
        bitwise = bitwise and all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        q, k, v, do, lse, _, dlse = args
        want = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal=causal, sm_scale=D**-0.5)
        rel = [rel_err(g, w) for g, w in zip((dq, dk, dv), want)]
        log(f"K5/K6 flash bwd B={B} Hq={Hq} Hkv={Hkv} S={S} causal={causal} dlse={'randn' if nz else 0} D={D}: "
            f"max|d-plain|/max|plain| dq={rel[0]:.3g} dk={rel[1]:.3g} dv={rel[2]:.3g}")
        if not (rel[0] <= TOL["flash_bwd_dq"] and max(rel[1:]) <= TOL["flash_bwd_dkv"]):
            raise AssertionError(f"flash backward kernels disagree with flash_backward_plain: {rel}")
        errs["flash_bwd_dq"] = max(errs.get("flash_bwd_dq", 0.0), max_err(dq, want[0]))
        errs["flash_bwd_dkv"] = max(errs.get("flash_bwd_dkv", 0.0), max_err(dk, want[1]), max_err(dv, want[2]))
    log(f"K5/K6 flash bwd: second launches bitwise equal to the first in every case: {bitwise}")
    return bitwise


def phase_int8_kernels_vs_plain(pa, errs: dict) -> None:
    """The int8 matmul, int8 decode and int8 scatter kernels against their
    plain versions on the same inputs."""
    from modal_examples_tpu_torch.models.quantize import quantize_weight
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(4)
    for K, N in QMM_SHAPES:
        w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda"))
        for M in QMM_MS:  # one slot, decode, both sides of the ring's limit, ragged, the prefill batch 4 x 512
            x = rand_bf16(gen, M, K)
            path = qmm.kernel_path(x, w.q)
            out = qmm.qmm_cuda(x, w.q, w.scale)
            torch.cuda.synchronize()
            want = qmm.qmm_plain(x, w.q, w.scale)
            rel = rel_err(out, want)
            again = qmm.qmm_cuda(x, w.q, w.scale)  # the split-K sum runs in a fixed order
            log(f"K7 int8 matmul M={M} K={K} N={N} path {path}: max|out-plain|/max|plain|={rel:.3g}")
            if not rel <= TOL["quantized_matmul"]:
                raise AssertionError(f"int8 matmul kernel disagrees with its plain version: {rel}")
            if not torch.equal(out, again):
                raise AssertionError(f"int8 matmul M={M} K={K} N={N} differs from run to run")
            if (K, N) != (4000, 11000) and path != ("ring" if M <= 64 else "wgmma"):
                raise AssertionError(f"Llama-2-7B shape M={M} K={K} N={N} took the {path} path")
            errs["quantized_matmul"] = max(errs.get("quantized_matmul", 0.0), max_err(out, want))
        del w
    for label, c in decode_cases(gen, int8=True):
        e = check_decode("paged_decode_int8", pa.paged_decode_int8_cuda, pa.paged_decode_int8_plain, c, label)
        errs["paged_decode_int8"] = max(errs.get("paged_decode_int8", 0.0), e)
        del c
    for label, c in writeback_cases(gen, int8=True):
        e = check_writeback(pa, "paged_decode_writeback_int8", c, label)
        errs["paged_decode_writeback_int8"] = max(errs.get("paged_decode_writeback_int8", 0.0), e)
        del c
    for label, L, N, Hkv, D in SCATTER_INT8_CASES:
        e = check_scatter_int8(pa, gen, label, L, N, Hkv, D)
        errs["kv_scatter_int8"] = max(errs.get("kv_scatter_int8", 0.0), e)


# K3-int8 against its plain version, bitwise: (label, L, N, Hkv, D) into 513
# pages of 16, each with an all-zero K row, a V row on .5 steps and the two
# equal dead rows of scatter_case (N > 3)
SCATTER_INT8_CASES = [
    ("decode step", 32, 8, 32, 128),
    ("prefill batch (blocks stride, a partial last pass)", 32, 2048, 32, 128),
    ("one layer's view through scatter_kv_layer", 1, 8, 32, 128),
    ("one token", 32, 1, 32, 128),
    ("odd N, a partial last block", 3, 37, 5, 256),
    ("GQA", 32, 8, 8, 128),
    ("D=64", 32, 37, 8, 64),
    ("D=256", 32, 8, 32, 256),
]


def check_scatter_int8(pa, gen, label: str, L: int, N: int, Hkv: int, D: int) -> float:
    """K3-int8 on one ``SCATTER_INT8_CASES`` case against its plain version,
    bitwise (``pages_err``); the all-zero row must read scale 1.0 and data 0;
    two planted faults on the kernel's own output, each one row wrong, must
    be refused by the same check: the walk's last row left unwritten (a lost
    group) and the first row's scale taken from its neighbouring head.
    Returns the error (0.0)."""
    P = 513
    k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P, Hkv, D, dead=N > 3)
    k_all[0, 0, 0] = 0.0  # scale 1.0, data 0
    half = torch.randint(-127, 127, (D,), generator=gen, device="cuda").float() + 0.5
    half[0] = 127.0  # scale exactly 1: every other value is a tie, rounded half to even
    v_all[0, 0, 0] = half.to(torch.bfloat16)
    one_layer = label.startswith("one layer")
    cache = (int8_pages(gen, 4 if one_layer else L, P, 16, Hkv, D), int8_pages(gen, 4 if one_layer else L, P, 16, Hkv, D))
    orig_v = clone_pages(cache[1])
    want = tuple(clone_pages(c) for c in cache)
    if one_layer:  # layer 2 of a 4-layer cache, as the write-then-attend path views it
        pa.scatter_kv_layer(cache[0][2], cache[1][2], k_all[0], v_all[0], page_idx, slot)
        pa.scatter_int8_plain(want[0][2:3], want[1][2:3], k_all, v_all, page_idx.long(), slot.long())
        layer0 = 2
    else:
        pa.scatter_int8_cuda(*cache, k_all, v_all, page_idx, slot)
        pa.scatter_int8_plain(*want, k_all, v_all, page_idx.long(), slot.long())
        layer0 = 0
    torch.cuda.synchronize()
    e = max(pages_err(g, w) for g, w in zip(cache, want))
    first = (layer0, int(page_idx[0]), int(slot[0]))
    zero_scale, zero_data = cache[0].scale[first][0].item(), cache[0].data[first][0].abs().max().item()
    log(f"K3-int8 scatter {label}: L={L} N={N} Hkv={Hkv} D={D} partition (lanes, rows a group, groups a block, "
        f"blocks) {pa.scatter_int8_partition(L, N, Hkv, D, torch.cuda.get_device_properties(0).multi_processor_count)}"
        f": pages vs plain (int8 data and f32 scales) {e}; all-zero row scale {zero_scale} max|data| {zero_data}")
    # planted faults, each on a copy of the kernel's output
    last = (layer0 + L - 1, int(page_idx[-1]), int(slot[-1]), Hkv - 1)
    lost = clone_pages(cache[1])
    lost.data[last], lost.scale[last] = orig_v.data[last], orig_v.scale[last]
    swapped = clone_pages(cache[0])
    swapped.scale[first + (0,)] = swapped.scale[first + (1,)]
    faults = {"the last row left unwritten (a lost group)": pages_err(lost, want[1]),
              "the first row's scale from its neighbouring head": pages_err(swapped, want[0])}
    log(f"  planted faults: {faults}")
    if not all(err > 0.0 for err in faults.values()):
        raise AssertionError(f"the int8 scatter check does not see a planted fault: {faults}")
    if e != 0.0:
        raise AssertionError(f"int8 scatter kernel is not bitwise equal to its plain version ({label}): {e}")
    if zero_scale != 1.0 or zero_data != 0:
        raise AssertionError(f"an all-zero row reads scale {zero_scale}, max|data| {zero_data}")
    return e


# -- phase 3 ----------------------------------------------------------------------


def make_requests(SamplingParams):
    """8 requests: prompts of 20..700 byte tokens (one past the 512 bucket),
    max_tokens 32..64, greedy and seeded rows mixed."""
    rng = np.random.default_rng(0)
    lens = [20, 64, 130, 200, 300, 450, 511, 700]
    out = []
    for i, n in enumerate(lens):
        prompt = "".join(chr(c) for c in rng.integers(32, 127, n - 1))  # + BOS = n tokens
        params = SamplingParams(
            max_tokens=int(32 + 32 * i / 7),
            temperature=0.0 if i % 2 == 0 else 0.8,
            seed=None if i % 4 == 1 else 1000 + i,
            top_p=0.9 if i == 3 else 1.0,
        )
        out.append((prompt, params))
    return out


def check_finish(req) -> None:
    p = req.params
    if req.finish_reason == "length":
        ok = req.n_generated == p.max_tokens == len(req.generated_tokens)
    elif req.finish_reason == "stop":  # sampled eos: consumed, not kept
        ok = req.n_generated == len(req.generated_tokens) + 1 <= p.max_tokens
    else:
        ok = False
    if not ok:
        raise AssertionError(
            f"{req.request_id}: finish {req.finish_reason} with {req.n_generated} tokens "
            f"({len(req.generated_tokens)} kept) for max_tokens={p.max_tokens}"
        )


def plain_mm(x, w, layers):
    """``layers.mm`` with no kernel: ``qmm_plain`` for an int8 weight,
    ``qmm_int4_plain`` for an int4 one."""
    from modal_examples_tpu_torch.models.quantize import QuantizedWeight
    from modal_examples_tpu_torch.ops.quantized_matmul import qmm_int4_plain, qmm_plain

    if isinstance(w, QuantizedWeight):
        plain = qmm_int4_plain if w.bits == 4 else qmm_plain
        return plain(x.reshape(-1, x.shape[-1]), w.q, w.scale).reshape(*x.shape[:-1], w.shape[-1])
    return layers.mm(x, w)


def plain_moe(layer, h, cfg, layers, routes: list | None = None, forced=None):
    """The reference's serving experts (``moe_swiglu_nodrop``) from plain
    versions: the router and every expert on f32 activations (bf16 weights
    widened to f32, int8 ones through ``qmm_plain``, int4 ones through
    ``qmm_int4_plain``), each token's top k
    renormalised, the combine summed in f32, the result in ``h``'s dtype.
    ``forced`` ([T, k] expert indices) replaces each token's top k by the
    given experts, weighted by their own probabilities here. Appends
    (probs [T, E], top-k indices [T, k]) to ``routes``."""
    import torch.nn.functional as F

    from modal_examples_tpu_torch.models.moe import _expert

    x = h.reshape(-1, cfg.dim).float()
    probs = torch.softmax(x @ layer["router"].float(), dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k_experts, dim=-1)
    if forced is not None:
        top_i = forced.to(top_i.device).long()
        top_p = probs.gather(1, top_i)
    combine = torch.zeros_like(probs).scatter_(1, top_i, top_p / top_p.sum(dim=-1, keepdim=True))
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        # the port's own expert view: an int4 stack keeps its bits and rows
        wg, wu, wd = (_expert(w, e) for w in (layer["moe_gate"], layer["moe_up"], layer["moe_down"]))
        y = plain_mm(F.silu(plain_mm(x, wg, layers)) * plain_mm(x, wu, layers), wd, layers)
        out += combine[:, e, None] * y
    if routes is not None:
        routes.append((probs, top_i))
    return out.reshape(h.shape).to(h.dtype)


def dense_reference_logits(params, cfg, tokens, layers, reference, n_cached: int = 0, all_positions: bool = False,
                           routes: list | None = None, forced: list | None = None, input_embeds=None):
    """Last-position logits (every position's, ``[S, vocab]``, with
    ``all_positions``) of a dense causal forward built from the plain
    versions (no kernel): the reference for the served path. Int8 weights go
    through ``qmm_plain``; K and V at the first ``n_cached`` positions (those
    the served path reads back from an int8 cache) go through
    ``dequantize_kv(quantize_kv(.))``. A mixture of experts runs
    :func:`plain_moe`, its routing appended to ``routes`` layer by layer,
    with layer l's experts forced to ``forced[l]`` where that is given.
    ``input_embeds`` [1, P, dim] takes the first P positions' embeddings
    (the multimodal prefix), in the model dtype."""
    import torch.nn.functional as F

    from modal_examples_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv

    def cached(t):  # [1, H, S, D]
        if not n_cached:
            return t
        return torch.cat([dequantize_kv(quantize_kv(t[:, :, :n_cached]), t.dtype), t[:, :, n_cached:]], dim=2)

    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None]
    cos, sin = layers.rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    x = params["embed"][tokens]
    if input_embeds is not None:
        x = torch.cat([input_embeds.to(x.dtype), x[:, input_embeds.shape[1]:]], dim=1)
    D = cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        h = layers.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = plain_mm(h, layer["wq"], layers).to(x.dtype).view(1, S, cfg.n_heads, D).transpose(1, 2)
        k = plain_mm(h, layer["wk"], layers).to(x.dtype).view(1, S, cfg.n_kv_heads, D).transpose(1, 2)
        v = plain_mm(h, layer["wv"], layers).to(x.dtype).view(1, S, cfg.n_kv_heads, D).transpose(1, 2)
        o = reference.attention(layers.apply_rope(q, cos, sin), cached(layers.apply_rope(k, cos, sin)), cached(v))
        x = x + plain_mm(o.transpose(1, 2).reshape(1, S, -1), layer["wo"], layers).to(x.dtype)
        h = layers.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts:
            x = x + plain_moe(layer, h, cfg, layers, routes, None if forced is None else forced[li])
            continue
        gate, up = plain_mm(h, layer["gate"], layers), plain_mm(h, layer["up"], layers)
        x = x + plain_mm((F.silu(gate) * up).to(x.dtype), layer["down"], layers).to(x.dtype)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return plain_mm(x[0] if all_positions else x[:, -1], params["lm_head"], layers)


def served_logits(eng, llama) -> tuple:
    """Prefill 99 random tokens + one decode step (the engine's
    ``paged_impl``) through the kernels, in a small cache of the engine's kv
    dtype of their own. Returns (the 100 tokens, {"prefill", "decode":
    logits [1, vocab]}, how many positions the decode step reads back from
    an int8 cache)."""
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    cfg, params = eng.cfg, eng.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, 256, (1, 100), generator=gen, device="cuda", dtype=torch.int32)
    cache = PagedKVCache.create(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        n_pages=9, page_size=16, kv_dtype=eng.cache.kv_dtype, device="cuda",
    )
    tables = torch.arange(1, 9, device="cuda", dtype=torch.int32)[None]
    padded = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
    padded[0, :99] = toks[0, :99]
    pre, _, _ = llama.prefill(params, padded, cache.k_pages, cache.v_pages, tables,
                              torch.tensor([99], device="cuda"), cfg)
    dec, _, _ = llama.decode_step(params, toks[0, 99:], torch.tensor([99], device="cuda"),
                                  cache.k_pages, cache.v_pages, tables,
                                  torch.tensor([True], device="cuda"), cfg, impl=eng.paged_impl)
    # prefill attends over its own K/V before they are written; the decode
    # step reads the 99 cached positions back from the cache
    return toks, {"prefill": pre, "decode": dec}, 99 if cache.quantized else 0


def logits_vs(name: str, got, ref, vocab: int, hold: bool = True) -> dict:
    """Max relative error and cosine of ``got`` against ``ref``, logged;
    with ``hold``, refused outside cosine > 0.999 and max rel err < 5e-2."""
    if got.shape != (1, vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"{name} logits malformed: {tuple(got.shape)}")
    rel = max_err(got, ref) / ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float()).item()
    log(f"{name} logits vs dense plain forward: max rel err {rel:.3g}, cosine {cos:.6f}, "
        f"argmax {int(got.argmax())} vs {int(ref.argmax())}")
    if hold and not (rel < 5e-2 and cos > 0.999):
        raise AssertionError(f"{name} logits disagree with the dense plain forward")
    return {"max_rel_err": rel, "cosine": cos}


def check_against_dense(eng, llama, layers, reference):
    """Prefill 99 tokens + one decode step (:func:`served_logits`) against
    the dense plain forward of the same 100 tokens. Returns (errors, prefill
    logits, tokens)."""
    toks, got, n_cached = served_logits(eng, llama)
    out = {}
    for name, n, nc in (("prefill", 99, 0), ("decode", 100, n_cached)):
        ref = dense_reference_logits(eng.params, eng.cfg, toks[:, :n], layers, reference, nc)
        out[name] = logits_vs(name, got[name], ref, eng.cfg.vocab_size)
    return out, got["prefill"], toks


class BlockWatch:
    """Watches an engine's pipelined decode loop while it serves, through
    wrappers on the instance (``with BlockWatch(eng) as w: ...``): the decode
    steps its dispatches queued (``dispatched_steps``: ``decode_block`` a
    block, N a macro-step, each cut to its slots' largest budget, every one
    of which runs on the card), each
    dispatch's host ms and its block's device span (CUDA events before its
    first launch and after its last: while the host launches slower than
    the card runs, the card waits on each launch and the span is the
    launching time, not the kernels' busy time, which ``profile_engine.py``
    reads), dispatches that returned with their block still running, the
    peak of blocks in flight when one is read, the rows of a block being read
    whose slot another request took meanwhile (``recycled``), and the
    harvests of parked first tokens that followed a dispatch in their tick.
    ``sync_probe(k)`` runs the k-th dispatch under
    ``torch.cuda.set_sync_debug_mode("warn")`` and counts the synchronizing
    operations PyTorch reports in it (a blocking copy, a read of a device
    value): a dispatch must have none, or it would wait for the block in
    flight. (A device wait queued ahead of a dispatch cannot show this: a
    block is thousands of launches, and once the CUDA launch queue is
    full the host waits for room whether or not it synchronizes.)"""

    def __init__(self, eng):
        self.eng = eng
        self.dispatches, self.dispatched_steps, self.busy_at_return = 0, 0, 0
        self.peak, self.recycled, self.harvest_after_dispatch = 0, 0, 0
        self.events = []  # (host ms, start event, end event, steps)
        self.probe_at, self.probe = None, None
        self._dispatched = False

    def __enter__(self):
        eng = self.eng
        self._orig = eng._dispatch_block, eng._process_block, eng._harvest_prefills, eng.step
        dispatch, process, harvest, step = self._orig

        def dispatch_block(live):
            probe = self.dispatches == self.probe_at
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            if probe:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = dispatch(live)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = [str(w.message).splitlines()[0] for w in caught if "called a synchronizing" in str(w.message)]
                self.probe = {"dispatch": self.dispatches, "sync_warnings": len(syncs), "first": syncs[:1]}
            else:
                out = dispatch(live)
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            steps = eng._inflight[-1][3][0]  # the block's dispatched steps
            self.busy_at_return += not end.query()
            self.dispatches += 1
            self.dispatched_steps += steps
            self.events.append((host_ms, start, end, steps))
            self._dispatched = True
            return out

        def process_block():
            self.peak = max(self.peak, len(eng._inflight))
            self.recycled += sum(1 for i, _req, tenancy in eng._inflight[0][2]
                                 if eng.slots[i].request is not None and eng.slots[i].tenancy != tenancy)
            return process()

        def harvest_prefills():
            if eng._pending_harvest and self._dispatched:
                self.harvest_after_dispatch += 1
            return harvest()

        def tick():
            self._dispatched = False
            return step()

        eng._dispatch_block, eng._process_block, eng._harvest_prefills, eng.step = (
            dispatch_block, process_block, harvest_prefills, tick)
        return self

    def __exit__(self, *exc):
        # the wrappers go once the scheduler is idle
        settle(self.eng)
        for name in ("_dispatch_block", "_process_block", "_harvest_prefills", "step"):
            self.eng.__dict__.pop(name, None)

    def sync_probe(self, k: int) -> None:
        self.probe_at = k

    def timings(self) -> dict:
        """Medians of the dispatches' host ms and their blocks' device spans."""
        torch.cuda.synchronize()
        host = [h for h, _, _, _ in self.events]
        span = [a.elapsed_time(b) for _, a, b, _ in self.events]
        return {"dispatches": self.dispatches, "dispatch_host_ms_median": statistics.median(host) if host else None,
                "block_span_ms_median": statistics.median(span) if span else None,
                "busy_at_return": self.busy_at_return}


def settle(eng, timeout: float = 60.0) -> None:
    """Wait until the scheduler thread has read every block in flight (a
    block leaves ``_inflight`` before its read counts its steps, so the step
    count must also hold still across two looks)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        now = None if eng._inflight else eng.stats.steps
        if now is not None and now == last:
            return
        last = now
        time.sleep(0.05)
    raise AssertionError("the engine did not settle")


def serve_burst(eng, SamplingParams, label: str, requests=None, watch: BlockWatch | None = None):
    """``requests`` (default: the 8 of ``make_requests``) through ``eng``,
    every finish checked. Returns (requests, metrics: burst tok/s, decode
    tok/s, TTFT median, wall, decode steps counted by the engine, decode
    steps dispatched). Burst tok/s is every generated token over the
    burst's wall time, text delivered included, so it times the same work
    at any ``decode_steps``; decode tok/s is the engine's decode clock
    (dispatches and block reads), which at N > 1 leaves out the
    detokenization the worker thread does. The kernels launch once a layer
    for every dispatched step: a block runs its ``decode_block`` steps, a
    macro-step its N, each cut to the largest budget of its slots, a
    macro-step's also after its lanes died (the engine counts only the
    steps with a live lane)."""
    settle(eng)
    steps0 = eng.stats.steps
    dec_s0, dec_t0 = eng.stats.decode_seconds, eng.stats.decode_tokens
    with BlockWatch(eng) if watch is None else watch as w:
        t0 = time.monotonic()
        # tokenized first, then queued back to back: the running scheduler finds
        # the whole burst at one tick, so every run prefills the same groups
        reqs = [eng.make_request(p, sp) for p, sp in (requests or make_requests(SamplingParams))]
        for r in reqs:
            eng.submit_request(r)
        texts = ["".join(eng.stream(r)) for r in reqs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    steps = eng.stats.steps - steps0
    log(f"{label}: {len(reqs)} requests in {wall:.2f}s, decode steps {steps} counted, {w.dispatched_steps} "
        f"dispatched, decode_steps N={eng.decode_steps}, plan {eng.impl_plan}")
    for r, t in zip(reqs, texts):
        check_finish(r)
        log(f"  {r.request_id}: prompt {len(r.prompt_tokens)} tok, {r.finish_reason}, "
            f"{r.n_generated} generated, ttft {r.first_token_at - r.created:.3f}s, {len(t)} chars")
    check_pages_returned(eng, label)
    return reqs, {
        "burst_tok_per_s": sum(r.n_generated for r in reqs) / wall,
        "decode_tok_per_s": (eng.stats.decode_tokens - dec_t0) / (eng.stats.decode_seconds - dec_s0),
        "ttft_s_median": statistics.median(r.first_token_at - r.created for r in reqs),
        "wall_s": wall,
        "decode_steps": steps,
        "dispatched_steps": w.dispatched_steps,
    }


def check_pages_returned(eng, label: str) -> None:
    """Every page back: free, or cached in the prefix trie with no reference."""
    pc = eng.prefix_cache
    cached = pc.cached_pages if pc is not None else 0
    held = [n.page_id for n in pc._by_page.values() if n.refcount] if pc is not None else []
    if eng.cache.allocator.available + cached != eng.cache.n_pages - 1 or held:
        raise AssertionError(f"{label}: pages not all returned after the requests finished "
                             f"({eng.cache.allocator.available} free, {cached} cached, {len(held)} still held)")


def check_same_tokens(reqs, ref_reqs, label: str) -> int:
    """Greedy and seeded rows must repeat ``ref_reqs`` token for token (rows
    are independent in every kernel and GEMM); rows with an engine-assigned
    seed draw a new one per submit and are skipped. Returns the rows held."""
    held = 0
    for r, ref in zip(reqs, ref_reqs):
        if r.params.temperature > 0 and r.params.seed is None:
            continue
        if (r.generated_tokens, r.finish_reason) != (ref.generated_tokens, ref.finish_reason):
            raise AssertionError(f"{label}: {r.request_id} tokens differ from the reference run")
        held += 1
    log(f"{label}: {held} greedy and seeded rows token-identical to the reference run")
    return held


def phase_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams):
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"llama2-7b random bf16 init: {time.monotonic() - t0:.1f}s, {cfg.param_count / 1e9:.2f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    eng = LLMEngine(cfg, params, max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512),
                    prefill_batch=4, decode_block=8, seed=0, device="cuda")
    # warm the path (allocator, cuBLAS handles) with one short request, off the count
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = pa.decode_launches = pa.scatter_launches = 0
    reqs, metrics = serve_burst(eng, SamplingParams, "engine")
    counts = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    steps = metrics["dispatched_steps"]
    log(f"engine launches {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    if counts["paged_decode"] != cfg.n_layers * steps:
        raise AssertionError(f"decode launches {counts['paged_decode']} != {cfg.n_layers} x {steps} dispatched steps")
    metrics["launches"] = counts
    log(f"engine metrics: {json.dumps(metrics)}")
    metrics["tokens"] = [(r.generated_tokens, r.finish_reason) for r in reqs]  # phase 8b's reference rows
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
    # the macro-step replay: the same engine and burst, 8 steps per dispatch
    eng.decode_steps = 8
    fa.launches = pa.decode_launches = pa.scatter_launches = 0
    reqs8, m8 = serve_burst(eng, SamplingParams, "engine, macro-step N=8")
    m8["launches"] = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    # every dispatched step launches the decode kernel once a layer (the
    # macro-step decides on the card which steps hold a live lane; stats.steps
    # counts only those)
    if m8["launches"]["paged_decode"] != cfg.n_layers * m8["dispatched_steps"]:
        raise AssertionError(f"macro-step decode launches {m8['launches']} != {cfg.n_layers} x "
                             f"{m8['dispatched_steps']} dispatched steps")
    m8["rows_held"] = check_same_tokens(reqs8, reqs, "engine, macro-step N=8 against N=1")
    eng.decode_steps = 1
    log(f"engine macro-step N=8 metrics: {json.dumps(m8)} (N=1: burst {metrics['burst_tok_per_s']:.1f} tok/s, "
        f"decode {metrics['decode_tok_per_s']:.1f} tok/s, TTFT median {metrics['ttft_s_median']:.3f}s)")
    metrics["macro_step_8"] = m8
    return eng, metrics


class unfolded_writes:
    """Within it, the write-then-attend step runs as before the folded
    write: K3 over the one-layer view, then K4 (``pa.write_then_attend``,
    which ``llama`` looks up at each call, swapped)."""

    def __init__(self, pa):
        self.pa, self.fold = pa, pa.write_then_attend

    def __enter__(self):
        pa = self.pa

        def scatter_then_attend(q, k_pages, v_pages, page_tables, context_lens, k_new, v_new, page_idx, slot, *,
                                positions=None, chain=1, sm_scale=None):
            pa.scatter_kv_layer(k_pages, v_pages, k_new, v_new, page_idx, slot)
            return pa.paged_decode_attention(q, k_pages, v_pages, page_tables, context_lens, sm_scale=sm_scale)

        pa.write_then_attend = scatter_then_attend
        return self

    def __exit__(self, *exc):
        self.pa.write_then_attend = self.fold


def phase_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params) -> dict:
    """Phase 3b: the same weights and burst through ``paged_impl=
    "pallas-writeback"`` at ``decode_steps=8``, counters zeroed just before
    and read just after: K4 once a layer a step, every launch folded (the
    step's rows written by K4 itself), K3 only in prefills (one a prefill
    call, as K1 is once a layer); then the same engine at N=1; then at N=1
    with the writes unfolded (``unfolded_writes``: K3, then K4): the three
    runs' tokens identical; then the dense check through the writeback
    decode step."""
    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, params, paged_impl="pallas-writeback", decode_steps=8, max_slots=8, max_model_len=1024,
                    prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8, seed=0, device="cuda")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    out = {}
    L = cfg.n_layers
    for n, fold in ((8, True), (1, True), (1, False)):
        eng.decode_steps = n
        fa.launches = pa.decode_launches = pa.decode_writeback_launches = pa.scatter_launches = 0
        pa.decode_writeback_fold_launches = 0
        label = f"writeback engine, N={n}" + ("" if fold else ", writes unfolded (K3, then K4)")
        if fold:
            reqs, m = serve_burst(eng, SamplingParams, label)
        else:
            with unfolded_writes(pa):
                reqs, m = serve_burst(eng, SamplingParams, label)
        m["launches"] = {"flash_fwd": fa.launches, "paged_decode_writeback": pa.decode_writeback_launches,
                         "paged_decode_writeback_folded": pa.decode_writeback_fold_launches,
                         "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
        steps, counts = m["dispatched_steps"], m["launches"]
        log(f"{label} launches {counts}")
        if counts["paged_decode_writeback"] != L * steps or counts["paged_decode"]:
            raise AssertionError(f"writeback launches {counts}: want {L} x {steps} K4, no K2")
        if counts["flash_fwd"] < 1 or counts["flash_fwd"] % L:
            raise AssertionError(f"writeback launches {counts}: want K1 once a layer a prefill call")
        prefills = counts["flash_fwd"] // L
        want = (L * steps, prefills) if fold else (0, prefills + L * steps)
        if (counts["paged_decode_writeback_folded"], counts["kv_scatter"]) != want:
            raise AssertionError(f"{label} launches {counts}: want (folded K4, K3) {want}")
        out[(n, fold)] = (reqs, m)
    m8, m1, m1u = (out[k][1] for k in ((8, True), (1, True), (1, False)))
    m8["rows_held"] = check_same_tokens(out[(8, True)][0], out[(1, True)][0], "writeback engine, N=8 against N=1")
    m1["rows_held_unfolded"] = check_same_tokens(out[(1, True)][0], out[(1, False)][0],
                                                 "writeback engine at N=1, folded against unfolded")
    metrics = {"n8": m8, "n1": m1, "n1_unfolded": m1u, "launches": m8["launches"]}
    log(f"writeback engine: burst {m8['burst_tok_per_s']:.1f} tok/s at N=8, {m1['burst_tok_per_s']:.1f} at N=1; "
        f"decode {m8['decode_tok_per_s']:.1f} / {m1['decode_tok_per_s']:.1f} tok/s; "
        f"TTFT median {m8['ttft_s_median']:.3f}s at N=8, {m1['ttft_s_median']:.3f}s at N=1")
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
    eng.stop()
    return metrics


def phase_server(eng, OpenAIServer) -> None:
    srv = OpenAIServer(eng, model_name="llama2-7b", port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"content-type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read().decode()

        status, body = post("/v1/completions", {"prompt": "The capital of France is", "max_tokens": 16, "temperature": 0})
        out = json.loads(body)
        if status != 200 or out["choices"][0]["finish_reason"] not in ("length", "stop"):
            raise AssertionError(f"completion failed: {status} {body[:300]}")
        log(f"server /v1/completions: {out['usage']}, finish {out['choices'][0]['finish_reason']}")
        status, body = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hello."}], "max_tokens": 16, "seed": 1,
            "stream": True, "stream_options": {"include_usage": True},
        })
        events = [e for e in body.split("\n\n") if e]
        if status != 200 or events[-1] != "data: [DONE]":
            raise AssertionError(f"streamed chat failed: {status} {body[-300:]}")
        usage = json.loads(events[-2][len("data: "):])["usage"]
        log(f"server streamed /v1/chat/completions: {len(events) - 3} content chunks, usage {usage}")
    finally:
        srv.stop()  # also stops the engine


# -- int8 serving -------------------------------------------------------------------


def phase_int8_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params, bf16_cache_bytes):
    """The same bf16 weights quantized by ``quantize_llama`` (passed to the
    engine with ``quantization=None``), an int8 KV cache, the same 8
    requests; counters zeroed just before the burst and read just after."""
    from modal_examples_tpu_torch.models import quantize
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    qparams = quantize.quantize_llama(params)
    torch.cuda.synchronize()
    w_ratio = quantize.param_bytes(qparams) / quantize.param_bytes(params)
    eng = LLMEngine(cfg, qparams, quantization=None, kv_dtype="int8", max_slots=8, max_model_len=1024,
                    prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8, seed=0, device="cuda")
    c_ratio = eng.cache.bytes() / bf16_cache_bytes
    log(f"int8: quantize_llama {time.monotonic() - t0:.1f}s; weights {quantize.param_bytes(qparams) / 1e9:.3f} GB "
        f"({w_ratio:.4f} of bf16), cache {eng.cache.bytes() / 1e9:.3f} GB ({c_ratio:.4f} of bf16), plan {eng.impl_plan}")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = pa.decode_launches = pa.scatter_launches = pa.decode_int8_launches = pa.scatter_int8_launches = 0
    qmm.qmm_launches = 0
    _, metrics = serve_burst(eng, SamplingParams, "int8 engine")
    counts = {"flash_fwd": fa.launches, "quantized_matmul": qmm.qmm_launches,
              "paged_decode_int8": pa.decode_int8_launches, "kv_scatter_int8": pa.scatter_int8_launches,
              "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
    steps = metrics["dispatched_steps"]
    log(f"int8 engine launches {counts}")
    per_pass = 7 * cfg.n_layers + 1  # seven projections a layer, then lm_head
    if counts["paged_decode_int8"] != cfg.n_layers * steps:
        raise AssertionError(f"int8 decode launches {counts['paged_decode_int8']} != {cfg.n_layers} x {steps} "
                             "dispatched steps")
    if counts["paged_decode"] or counts["kv_scatter"]:
        raise AssertionError(f"the int8 path launched a bf16 cache kernel: {counts}")
    if counts["kv_scatter_int8"] < 1 or counts["flash_fwd"] < 1:
        raise AssertionError(f"a kernel of the int8 path never launched: {counts}")
    if counts["quantized_matmul"] % per_pass or counts["quantized_matmul"] < per_pass * steps:
        raise AssertionError(f"int8 matmul launches {counts['quantized_matmul']}: want a multiple of {per_pass}, "
                             f"at least {per_pass} x {steps} steps")
    if not (w_ratio <= 0.52 and c_ratio <= 0.52):
        raise AssertionError(f"int8 bytes over 0.52 of bf16: weights {w_ratio}, cache {c_ratio}")
    metrics.update(
        launches=counts, weight_gb=quantize.param_bytes(qparams) / 1e9, weight_ratio=w_ratio,
        cache_gb=eng.cache.bytes() / 1e9, cache_ratio=c_ratio,
    )
    log(f"int8 engine metrics: {json.dumps(metrics)}")
    metrics["dense_check"], pre, toks = check_against_dense(eng, llama, layers, reference)
    bf16_ref = dense_reference_logits(params, cfg, toks[:, :99], layers, reference)
    metrics["prefill_cosine_vs_bf16_model"] = torch.nn.functional.cosine_similarity(pre.float(), bf16_ref.float()).item()
    log(f"int8 prefill logits vs the bf16 model's dense forward (logged, not held to a bound): cosine "
        f"{metrics['prefill_cosine_vs_bf16_model']:.6f}, argmax {int(pre.argmax())} vs {int(bf16_ref.argmax())}")
    eng.stop()
    return metrics, qparams


def phase_int8_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, qparams) -> dict:
    """Phase 3b over int8 pages: the int8 weights ``qparams`` in an engine
    with an int8 KV cache and ``paged_impl="pallas-writeback"`` at
    ``decode_steps=8``, the 8 requests, counters zeroed just before the burst
    and read just after: K4-int8 n_layers x decode steps times, no other
    decode kernel, K3-int8 at least once a layer a step and no bf16 scatter;
    then prefill + one writeback decode step against the dense plain forward
    over the same int8 weights and cache rows."""
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, qparams, quantization=None, kv_dtype="int8", paged_impl="pallas-writeback", decode_steps=8,
                    max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512), prefill_batch=4,
                    decode_block=8, seed=0, device="cuda")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    fa.launches = qmm.qmm_launches = pa.scatter_launches = pa.scatter_int8_launches = 0
    pa.decode_launches = pa.decode_int8_launches = pa.decode_writeback_launches = pa.decode_writeback_int8_launches = 0
    _, metrics = serve_burst(eng, SamplingParams, "int8 writeback engine, N=8")
    counts = {"flash_fwd": fa.launches, "quantized_matmul": qmm.qmm_launches,
              "paged_decode_writeback_int8": pa.decode_writeback_int8_launches,
              "kv_scatter_int8": pa.scatter_int8_launches, "paged_decode_writeback": pa.decode_writeback_launches,
              "paged_decode": pa.decode_launches, "paged_decode_int8": pa.decode_int8_launches,
              "kv_scatter": pa.scatter_launches}
    steps = metrics["dispatched_steps"]
    log(f"int8 writeback engine N=8 launches {counts}")
    if counts["paged_decode_writeback_int8"] != cfg.n_layers * steps:
        raise AssertionError(f"int8 writeback launches {counts}: want {cfg.n_layers} x {steps} K4-int8")
    if counts["paged_decode_writeback"] or counts["paged_decode"] or counts["paged_decode_int8"] or counts["kv_scatter"]:
        raise AssertionError(f"the int8 writeback path launched another decode or a bf16 scatter kernel: {counts}")
    if counts["kv_scatter_int8"] < cfg.n_layers * steps or counts["flash_fwd"] < 1 or counts["quantized_matmul"] < 1:
        raise AssertionError(f"int8 writeback launches {counts}: want K3-int8 once a layer a step, K1 and K7")
    metrics["launches"] = counts
    log(f"int8 writeback engine metrics: {json.dumps(metrics)}")
    metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
    eng.stop()
    return metrics


# -- phase 7 ----------------------------------------------------------------------


def burst16(SamplingParams):
    """16 requests for 8 slots: prompts of 20..700 byte tokens (two past the
    512 bucket), 24..64 new tokens, greedy and seeded rows (no
    engine-assigned seed, so each can be served again alone)."""
    rng = np.random.default_rng(16)
    lens = [20, 700, 64, 130, 520, 200, 45, 300, 90, 450, 160, 33, 511, 250, 75, 380]
    out = []
    for i, n in enumerate(lens):
        prompt = "".join(chr(c) for c in rng.integers(32, 127, n - 1))  # + BOS = n tokens
        out.append((prompt, SamplingParams(max_tokens=24 + (40 * i) // 15, temperature=0.0 if i % 2 == 0 else 0.8,
                                           seed=None if i % 2 == 0 else 1600 + i)))
    return out


def clear_registry() -> None:
    """Empty the port's process registry, so phase 7's series are its engine's alone."""
    from modal_examples_tpu_torch.utils.prometheus import default_registry as reg

    with reg._lock:
        reg._counters.clear()
        reg._gauges.clear()
        reg._histograms.clear()


def http(base: str, path: str, body=None):
    """(status, headers, text) of one request to the server."""
    req = urllib.request.Request(base + path, data=None if body is None else json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read().decode()


def phase_pipeline(fa, pa, llama, LLMEngine, OpenAIServer, SamplingParams, params, phase3: dict) -> dict:
    """Phase 7: the pipelined engine at full width. (7a) Llama-2-7B, 8 slots,
    the profiler on: 16 requests over the 8 slots, counters zeroed just
    before and read just after (K1, K2, K3 launched; K2 n_layers x the
    dispatched steps); a block read with the next in flight, slots recycled
    under a block in flight, parked first tokens harvested after a dispatch,
    every page back; each request token-identical to itself served alone on
    the same engine; then the burst at ``decode_steps = 8``, identical.
    (7b) the OpenAI server over the engine: ``n = 3`` with a seed equal to
    the three singles at ``seed + i``, ``x-mtpu-request-id`` on the 200 and
    the stream, and ``/metrics`` (scraped idle) counting the engine's stats,
    no name twice. (7c) logged: the profiler's phases per tick (their sum
    within 5% of the tick), its host share, each dispatch's host ms against
    its block's device span, and one dispatch run under PyTorch's sync debug
    mode (it must report no synchronizing operation), the usage meter's
    shares per phase at the card's peaks (each at most 1.0, and the
    roofline gauges equal to them), and
    the burst's tok/s and TTFT beside phase 3's."""
    cfg = llama.LlamaConfig.llama2_7b()
    clear_registry()
    eng = LLMEngine(cfg, params, **SERVE_KW, profile=True)
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    requests = burst16(SamplingParams)
    out = {}
    runs = {}
    for n in (1, 8):
        eng.decode_steps = n
        fa.launches = pa.decode_launches = pa.scatter_launches = 0
        watch = BlockWatch(eng)
        watch.sync_probe(2)
        reqs, m = serve_burst(eng, SamplingParams, f"7a pipelined engine, 16 requests, N={n}", requests, watch)
        counts = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
        if min(counts.values()) <= 0 or counts["paged_decode"] != cfg.n_layers * watch.dispatched_steps:
            raise AssertionError(f"7a N={n} launches {counts}: want {cfg.n_layers} x {watch.dispatched_steps} K2, K1, K3")
        if watch.peak != 2 or watch.recycled < 1 or watch.harvest_after_dispatch < 1:
            raise AssertionError(f"7a N={n}: peak in flight {watch.peak}, recycled {watch.recycled}, harvests "
                                 f"after a dispatch {watch.harvest_after_dispatch}")
        m.update(launches=counts, peak_inflight=watch.peak, recycled_in_flight=watch.recycled,
                 harvests_after_dispatch=watch.harvest_after_dispatch, **watch.timings(), sync_probe=watch.probe)
        if watch.probe is None or watch.probe["sync_warnings"]:
            raise AssertionError(f"7a N={n}: the dispatch synchronized with the card: {watch.probe}")
        log(f"7a N={n}: {json.dumps(m)}")
        runs[n] = reqs
        out[f"n{n}"] = m
    out["rows_held_n8"] = check_same_tokens(runs[8], runs[1], "7a N=8 against N=1")
    eng.decode_steps = 1
    singles = []
    t0 = time.monotonic()
    for prompt, sp in requests:
        r = eng.submit(prompt, sp)
        "".join(eng.stream(r))
        singles.append(r)
    out["singles_s"] = time.monotonic() - t0
    out["rows_held_alone"] = check_same_tokens(runs[1], singles, "7a burst against each request served alone")
    if out["rows_held_alone"] != len(requests):
        raise AssertionError("7a: a row was not held against its single run")
    settle(eng)
    prof = eng.profiler.overhead_summary()
    ring = eng.profiler.perfetto_snapshot()["ticks"]
    worst = max(abs(sum(e["phases"].values()) - e["total"]) / e["total"] for e in ring)
    if worst > 0.05:
        raise AssertionError(f"7c: a tick's phases sum {worst:.3f} away from its total")
    out["profiler"] = {
        "ticks": prof["ticks"], "tick_p50_ms": prof["tick_p50"] * 1e3, "tick_p95_ms": prof["tick_p95"] * 1e3,
        "host_fraction": prof["host_fraction"], "worst_phase_sum_gap": worst,
        "phase_p50_ms": {k: v["p50"] * 1e3 for k, v in prof["phases"].items()},
    }
    m1 = out["n1"]
    # the meter's own shares, as /metrics serves them: its work over the
    # card's spans of that work (CUDA events around each block and prefill)
    from modal_examples_tpu_torch.observability import catalog as C
    from modal_examples_tpu_torch.utils.prometheus import default_registry

    eng.usage.flush()
    phases = eng.usage.summary()["phases"]
    peaks = eng.usage.peaks
    if peaks["tflops_per_chip"] is None:
        raise AssertionError(f"7c: no peaks for this card: {peaks}")
    shares = {p: (phases[p]["mfu"], phases[p]["mbu"]) for p in phases}
    if not all(v is not None and 0 < v <= 1.0 for pair in shares.values() for v in pair):
        raise AssertionError(f"7c: the usage meter's shares (mfu, mbu) {shares}")
    served = tuple(default_registry.value(name, {"phase": "total"}) for name in (C.MFU, C.HBM_BW_UTIL))
    if served != shares["total"]:
        raise AssertionError(f"7c: the roofline gauges {served} are not the meter's {shares['total']}")
    out["usage"] = {"peaks": peaks, "shares_mfu_mbu": shares, "meter": phases}
    out["vs_phase3"] = {"burst_tok_per_s": (m1["burst_tok_per_s"], phase3["burst_tok_per_s"]),
                        "ttft_s_median": (m1["ttft_s_median"], phase3["ttft_s_median"])}
    log(f"7c: {json.dumps(out['profiler'])}; usage {json.dumps(out['usage'])}; 16-request burst at N=1 "
        f"{m1['burst_tok_per_s']:.1f} tok/s, TTFT median {m1['ttft_s_median']:.3f}s (phase 3's 8 requests: "
        f"{phase3['burst_tok_per_s']:.1f} tok/s, {phase3['ttft_s_median']:.3f}s); dispatch host ms "
        f"{m1['dispatch_host_ms_median']:.2f} against its block's device span {m1['block_span_ms_median']:.2f} "
        f"at N=1, {out['n8']['dispatch_host_ms_median']:.2f} against {out['n8']['block_span_ms_median']:.2f} at N=8")
    out["server"] = phase_pipeline_server(eng, OpenAIServer)
    return out


def phase_pipeline_server(eng, OpenAIServer) -> dict:
    """7b: ``n = 3`` against its seeded singles, the request id header, and
    ``/metrics`` against the engine's stats (the server stops the engine)."""
    from modal_examples_tpu_torch.observability import catalog as C

    srv = OpenAIServer(eng, model_name="llama2-7b", port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    out = {}
    try:
        body = {"prompt": "Three short stories about the sea:", "max_tokens": 24, "temperature": 0.8, "seed": 4242}
        status, _, text = http(base, "/v1/completions", {**body, "n": 3})
        choices = json.loads(text)["choices"]
        singles = []
        for i in range(3):
            s_status, headers, s_text = http(base, "/v1/completions", {**body, "seed": 4242 + i})
            if s_status != 200 or not headers.get("x-mtpu-request-id", "").startswith("req-"):
                raise AssertionError(f"7b single: {s_status}, headers {headers}")
            singles.append(json.loads(s_text)["choices"][0]["text"])
        if status != 200 or [c["text"] for c in choices] != singles:
            raise AssertionError(f"7b n=3: {status}, choices differ from the seeded singles")
        s_status, headers, s_text = http(base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hello."}], "max_tokens": 8, "stream": True})
        if s_status != 200 or not headers.get("x-mtpu-request-id", "").startswith("req-"):
            raise AssertionError(f"7b stream: {s_status}, headers {headers}")
        settle(eng)
        time.sleep(0.6)  # the idle loop flushes the counters (every 0.25 s)
        settle(eng)
        _, _, metrics = http(base, "/metrics")
        st = eng.stats
        names = re.findall(r"^# TYPE (\S+)", metrics, re.M)
        hand = [line.split("{")[0].split(" ")[0] for line in metrics.splitlines()
                if line and not line.startswith("#") and line.split("{")[0].split(" ")[0] not in names]
        hand = [h for h in hand if not any(h.startswith(n + "_") for n in names)]
        if len(names + hand) != len(set(names + hand)):
            raise AssertionError("7b /metrics: a metric name appears twice")
        got = {}
        for name, want in ((C.GENERATED_TOKENS_TOTAL, st.generated_tokens), (C.PROMPT_TOKENS_TOTAL, st.prompt_tokens),
                           (C.DECODE_STEPS_TOTAL, st.steps)):
            m = re.search(rf"^{name} (\S+)$", metrics, re.M)
            got[name] = (float(m.group(1)) if m else None, want)
            if m is None or float(m.group(1)) != want:
                raise AssertionError(f"7b /metrics {name}: {got[name]}")
        out = {"n3_choices": len(choices), "metrics_vs_stats": got, "metric_names": len(names) + len(hand)}
        log(f"7b server: {json.dumps(out)}")
    finally:
        srv.stop()
    return out


# -- phase 8 ----------------------------------------------------------------------

#: speculation depth of phase 8's engines (bench.py's spec configurations)
SPEC_GAMMA = 4
#: 8a's verify shape: 8 slots, chains of 5 from the ragged prefixes 0..1000
VERIFY_T = 5
#: phrases repeated into 8d's prompts, for prompt lookup (60..690 bytes)
NGRAM_PHRASES = ("the cat sat on the mat. ", "one two three four, ", "def f(x):\n    return x + 1\n")


def draft_1b_config(llama):
    """The 1B-shape draft of ``bench.py``'s ``llama2-7b-int8-spec-draft1b``
    (``bench.py:1365-1369``): the target's 32000 vocabulary."""
    return llama.LlamaConfig(vocab_size=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8, ffn_dim=5632,
                             max_seq_len=2048)


def verify_case(gen, int8: bool, Hq: int = 32, Hkv: int = 32, D: int = 128, ps: int = 16, pps: int = 64) -> dict:
    """8a's inputs: one layer's pages of a 4-layer cache (bf16, or int8 with
    scales) over shuffled pages, 8 slots, each a chain of ``VERIFY_T``
    queries from a prefix of ``DECODE_LENS`` (its last position at most
    1004, inside the 1024-row table)."""
    B = len(DECODE_LENS)
    P = 1 + B * pps
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))[: B * pps] + 1
    pages = int8_pages if int8 else rand_bf16
    k_cache, v_cache = pages(gen, 4, P, ps, Hkv, D), pages(gen, 4, P, ps, Hkv, D)
    pos0 = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    return dict(
        q=rand_bf16(gen, B, VERIFY_T, Hq, D), k_pages=k_cache[2], v_pages=v_cache[2],
        page_tables=perm.reshape(B, pps).to(torch.int32).cuda(),
        positions=pos0[:, None] + torch.arange(VERIFY_T, dtype=torch.int32, device="cuda")[None],
    )


def check_verify_route(pa, reference, int8: bool) -> dict:
    """8a, kernels: ``paged_verify_attention`` on the card (K4 or K4-int8 over
    B·T rows) against ``reference.paged_verify_attention`` on the card, held
    at K4's tolerances (each row within 1e-2 of its largest value; int8 also
    6e-2 max abs), two launches bitwise equal, and one planted fault refused
    by the same check (every chain query blind to its own row: contexts one
    short); then its device time beside the plain version's and the byte
    bound of the function (each lane's rows read once, q and o once)."""
    name = "paged_decode_writeback_int8" if int8 else "paged_decode_writeback"
    c = verify_case(torch.Generator(device="cuda").manual_seed(8), int8)
    args = [c[n] for n in ("q", "k_pages", "v_pages", "page_tables", "positions")]
    route = lambda: pa.paged_verify_attention(*args, sm_scale=128**-0.5)  # noqa: E731
    o, again = route(), route()
    want = reference.paged_verify_attention(*args, sm_scale=128**-0.5)
    B, T, Hq, D = c["q"].shape
    ctx = c["positions"] + 1  # [B, T]: every (lane, chain position, head) row has a context
    got = writeback_readings(o, want, ctx)
    blind = pa.paged_decode_attention(c["q"].reshape(B * T, Hq, D), c["k_pages"], c["v_pages"],
                                      c["page_tables"].repeat_interleave(T, 0), ctx.reshape(-1) - 1,
                                      sm_scale=128**-0.5)
    bad = writeback_readings(blind.view(B, T, Hq, D), want, ctx - 1)  # rows that still have a context
    limit_row = TOL[f"{name}_row"] if int8 else TOL[name]
    ok = lambda r: r["row_rel"] <= limit_row and (not int8 or r["max_abs"] <= TOL[name])  # noqa: E731
    log(f"8a {name} verify route, 8 slots x T={T} from prefixes {list(DECODE_LENS)}: {got}, bitwise equal on a "
        f"second launch {torch.equal(o, again)}; planted fault (contexts one short): {bad}")
    if ok(bad):
        raise AssertionError(f"8a: the {name} verify check does not see a planted fault: {bad}")
    if not ok(got) or not torch.equal(o, again):
        raise AssertionError(f"8a: the {name} verify route disagrees with paged_verify_attention: {got}")
    Hkv = c["k_pages"].shape[2]
    lane_rows = int((c["positions"][:, -1] + 1).sum())  # each lane's rows, once
    row_bytes = Hkv * (D + 4) if int8 else Hkv * D * 2  # int8 rows carry an f32 scale a head
    nbytes = 2 * lane_rows * row_bytes + 2 * B * T * Hq * D * 2
    out = {
        "shape": f"B=8 x T={T} Hq=Hkv=32 D=128, positions {list(DECODE_LENS)} + 0..{T - 1}",
        "rows_read_by_the_route": int(ctx.sum()), "rows_of_the_function": lane_rows,
        "device_ms": device_ms(route), "plain_ms": time_ms(lambda: reference.paged_verify_attention(
            *args, sm_scale=128**-0.5), reps=5),
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes", **got,
    }
    log(f"8a {name} verify route timing: {json.dumps(out)}")
    return out


def check_verify_step(llama, eng) -> dict:
    """8a, model: prefill 99 tokens, then ``verify_step`` over a 5-token chain
    against 5 sequential ``decode_step`` calls (the engine's decode structure)
    from the same prefill, each in its own small cache of the engine's kv
    dtype: every chain position's logits within the logits contract
    (cosine > 0.999, max rel err < 5e-2)."""
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    cfg, params = eng.cfg, eng.params
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, 256, (1, 104), generator=gen, device="cuda", dtype=torch.int32)
    tables = torch.arange(1, 9, device="cuda", dtype=torch.int32)[None]
    caches = []
    for _ in range(2):
        cache = PagedKVCache.create(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                    n_pages=9, page_size=16, kv_dtype=eng.cache.kv_dtype, device="cuda")
        padded = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
        padded[0, :99] = toks[0, :99]
        llama.prefill(params, padded, cache.k_pages, cache.v_pages, tables, torch.tensor([99], device="cuda"), cfg)
        caches.append(cache)
    active = torch.tensor([True], device="cuda")
    pos0 = torch.tensor([99], dtype=torch.int32, device="cuda")
    ver, _, _ = llama.verify_step(params, toks[:, 99:], pos0, caches[0].k_pages, caches[0].v_pages, tables, active,
                                  cfg)
    seq = []
    for t in range(VERIFY_T):
        lg, _, _ = llama.decode_step(params, toks[0, 99 + t : 100 + t], pos0 + t, caches[1].k_pages,
                                     caches[1].v_pages, tables, active, cfg, impl=eng.paged_impl)
        seq.append(lg[0])
    ref = torch.stack(seq)
    got = ver[0]
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"8a: verify_step logits malformed: {tuple(got.shape)}")
    rel = max_err(got, ref) / ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float()).min().item()
    out = {"max_rel_err": rel, "cosine_min": cos, "argmax_equal": int((got.argmax(-1) == ref.argmax(-1)).sum())}
    log(f"8a verify_step over {VERIFY_T} positions against {VERIFY_T} decode_steps ({eng.cache.kv_dtype} cache): "
        f"{json.dumps(out)}")
    if not (rel < 5e-2 and cos > 0.999):
        raise AssertionError(f"8a: verify_step disagrees with sequential decode steps: {out}")
    return out


def check_spec_exactness(eng, reqs, layers, reference, label: str) -> dict:
    """Every greedy token the engine committed, against a teacher-forced
    dense plain forward over the request's prompt and tokens (int8 weights
    through ``qmm_plain``; over an int8 cache every position's K/V
    dequantized from its int8 row, as the cache serves them): the forward's
    argmax at its position, or within 5e-2 x max|logit| of it. Counts the
    tokens that are not the argmax."""
    checked = not_argmax = 0
    worst = 0.0
    for r in reqs:
        if r.params.temperature > 0 or not r.generated_tokens:
            continue
        n = len(r.prompt_tokens)
        toks = torch.tensor([r.prompt_tokens + r.generated_tokens[:-1]], dtype=torch.int64, device="cuda")
        logits = dense_reference_logits(eng.params, eng.cfg, toks, layers, reference,
                                        n_cached=toks.shape[1] if eng.cache.quantized else 0, all_positions=True)
        rows = logits[n - 1 :].float()  # row j predicts generated token j
        gen = torch.tensor(r.generated_tokens, device="cuda")
        top = rows.max(dim=-1).values
        gap = (top - rows[torch.arange(len(gen), device="cuda"), gen]) / rows.abs().max(dim=-1).values
        checked += len(gen)
        not_argmax += int((gap > 0).sum())
        worst = max(worst, gap.max().item())
    out = {"greedy_tokens": checked, "not_argmax": not_argmax, "worst_gap_over_max_logit": worst}
    log(f"{label} exactness against the dense plain forward: {json.dumps(out)}")
    if not checked or worst > 5e-2:
        raise AssertionError(f"{label}: a committed greedy token is not the dense forward's argmax: {out}")
    return out


def spec_counts(fa, pa, qmm) -> dict:
    return {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches,
            "paged_decode_writeback": pa.decode_writeback_launches, "paged_decode_int8": pa.decode_int8_launches,
            "kv_scatter_int8": pa.scatter_int8_launches,
            "paged_decode_writeback_int8": pa.decode_writeback_int8_launches, "quantized_matmul": qmm.qmm_launches,
            "paged_decode_writeback_folded": pa.decode_writeback_fold_launches}


def zero_counts(fa, pa, qmm) -> None:
    fa.launches = qmm.qmm_launches = 0
    pa.decode_launches = pa.scatter_launches = pa.decode_writeback_launches = pa.decode_writeback_fold_launches = 0
    pa.decode_int8_launches = pa.scatter_int8_launches = pa.decode_writeback_int8_launches = 0


def serve_spec_burst(fa, pa, qmm, eng, SamplingParams, label: str, requests=None) -> tuple:
    """The burst through a speculating engine, counters zeroed just before
    and read just after. Every round launches the verify's attention once a
    target layer (K4, or K4-int8 over int8 pages); draft mode runs γ draft
    steps and the completion step every round (the masked scan runs every
    step on the card), so the draft's decode kernel launches n_draft_layers x
    (γ + 1) x rounds times, beside the target's n_layers x the steps of the
    fallback blocks. Returns (requests, metrics)."""
    zero_counts(fa, pa, qmm)
    r0, f0, p0, a0 = eng._spec_rounds, eng._spec_fallbacks, eng.stats.spec_proposed, eng.stats.spec_accepted
    t0 = eng._spec_round_tokens
    reqs, m = serve_burst(eng, SamplingParams, label, requests)
    counts = spec_counts(fa, pa, qmm)
    rounds, fallbacks = eng._spec_rounds - r0, eng._spec_fallbacks - f0
    proposed, accepted = eng.stats.spec_proposed - p0, eng.stats.spec_accepted - a0
    m.update(launches=counts, rounds=rounds, fallbacks=fallbacks, proposed=proposed, accepted=accepted,
             acceptance_rate=accepted / proposed if proposed else 0.0,
             tokens_per_round=(eng._spec_round_tokens - t0) / rounds if rounds else 0.0)
    L = eng.cfg.n_layers
    int8 = eng.cache.quantized
    verify = counts["paged_decode_writeback_int8" if int8 else "paged_decode_writeback"]
    decode = counts["paged_decode_int8" if int8 else "paged_decode"]
    draft_steps = 0 if eng.spec_mode == "ngram" else eng.draft_cfg.n_layers * (eng.spec_gamma + 1) * rounds
    want = {"verify": L * rounds, "decode": draft_steps + L * m["dispatched_steps"]}
    log(f"{label}: launches {counts}; rounds {rounds}, fallbacks {fallbacks} ({m['dispatched_steps']} steps "
        f"dispatched), proposed {proposed}, accepted {accepted}; want verify {want['verify']}, decode {want['decode']}")
    if rounds <= 0 or verify != want["verify"] or decode != want["decode"] or counts["flash_fwd"] < 1:
        raise AssertionError(f"{label}: launches {counts} against {want} ({rounds} rounds)")
    # the verify writes its chain: over int8 pages by K3-int8 first, over
    # bf16 pages by K4 itself (every verify launch folded)
    if int8 and counts["kv_scatter_int8"] < L * rounds:
        raise AssertionError(f"{label}: the verify's scatter launched {counts} times, under once a layer a round")
    if counts["paged_decode_writeback_folded"] != (0 if int8 else verify):
        raise AssertionError(f"{label}: {counts}: want every bf16 verify launch folded ({verify}), no other")
    other = ("paged_decode_writeback", "paged_decode", "kv_scatter") if int8 else (
        "paged_decode_writeback_int8", "paged_decode_int8", "kv_scatter_int8")
    if any(counts[k] for k in other):
        raise AssertionError(f"{label}: a kernel of the other cache dtype launched: {counts}")
    return reqs, m


def phase_speculation(fa, pa, llama, layers, reference, LLMEngine, OpenAIServer, SamplingParams, params,
                      phase3: dict) -> dict:
    """Phase 8: speculative decoding at full width (Llama-2-7B, the resident
    random bf16 weights, ``SERVE_KW``). (8a) the verify route against
    ``paged_verify_attention``, bf16 and int8 pages, with its timing; and
    ``verify_step`` against sequential decode steps. (8b) a self-draft (the
    target's own tensors, not copied) at γ = 4 serving phase 3's burst:
    launches, every greedy token at the dense forward's argmax (or within
    tolerance), acceptance, tokens a round, rows identical to phase 3's,
    finish reasons and pages, the usage meter's shares in (0, 1]. (8e)
    ``/metrics`` through the server on that engine: the speculation series
    equal to its stats. (8c) int8 weights and pages with the random 1B-shape
    draft at γ = 4 beside a non-speculating int8 engine, one burst each.
    (8d) prompt lookup (γ = 4) on prompts that repeat a phrase. Returns the
    metrics, with the launches of 8b-8d summed under ``launches``."""
    from modal_examples_tpu_torch.models import quantize
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    cfg = llama.LlamaConfig.llama2_7b()
    out = {"verify_route": {name: check_verify_route(pa, reference, int8) for name, int8 in (
        ("paged_decode_writeback", False), ("paged_decode_writeback_int8", True))}}
    clear_registry()
    eng = LLMEngine(cfg, params, **SERVE_KW, speculative=(cfg, SPEC_GAMMA), draft_params=params)
    if eng.draft_params is not params:
        raise AssertionError("8b: the self-draft's weights were copied")
    out["verify_step"] = check_verify_step(llama, eng)
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    reqs, m = serve_spec_burst(fa, pa, qmm, eng, SamplingParams, "8b self-draft, gamma 4")
    add(m["launches"])
    for r in reqs:
        check_finish(r)
    m["exactness"] = check_spec_exactness(eng, reqs, layers, reference, "8b")
    m["rows_identical_to_phase3"] = sum(
        (r.generated_tokens, r.finish_reason) == t for r, t in zip(reqs, phase3["tokens"]))
    eng.usage.flush()
    phases = eng.usage.summary()["phases"]
    shares = {p: (phases[p]["mfu"], phases[p]["mbu"]) for p in phases}
    if not all(v is not None and 0 < v <= 1.0 for pair in shares.values() for v in pair):
        raise AssertionError(f"8b: the usage meter's shares (mfu, mbu) {shares}")
    m["usage_shares_mfu_mbu"] = shares
    log(f"8b: {json.dumps(m)}")
    out["self_draft"] = m
    out["metrics"] = phase_spec_server(eng, OpenAIServer)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    qparams = quantize.quantize_llama(params)
    plain8 = LLMEngine(cfg, qparams, quantization=None, kv_dtype="int8", **SERVE_KW)
    plain8.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    _, pm = serve_burst(plain8, SamplingParams, "8c int8 engine, no speculation")
    plain8.stop()
    del plain8
    gc.collect()
    dcfg = draft_1b_config(llama)
    eng = LLMEngine(cfg, qparams, quantization=None, kv_dtype="int8", **SERVE_KW, speculative=(dcfg, SPEC_GAMMA))
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    reqs, m = serve_spec_burst(fa, pa, qmm, eng, SamplingParams, "8c int8 with the 1B-shape draft, gamma 4")
    add(m["launches"])
    if m["launches"]["quantized_matmul"] < 1:
        raise AssertionError(f"8c: the int8 matmul never launched: {m['launches']}")
    m["exactness"] = check_spec_exactness(eng, reqs, layers, reference, "8c")
    m["burst_tok_per_s_without_speculation"] = pm["burst_tok_per_s"]
    log(f"8c: {json.dumps(m)}; the same burst without speculation {pm['burst_tok_per_s']:.1f} tok/s, with "
        f"{m['burst_tok_per_s']:.1f} (one burst each, no claim)")
    out["int8_draft_1b"] = m
    eng.stop()
    del eng, qparams
    gc.collect()
    torch.cuda.empty_cache()

    eng = LLMEngine(cfg, params, **SERVE_KW, speculative=("ngram", SPEC_GAMMA))
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    requests = [((NGRAM_PHRASES[k % len(NGRAM_PHRASES)] * 40)[: 60 + 90 * k],
                 SamplingParams(max_tokens=48, temperature=0.0)) for k in range(8)]
    reqs, m = serve_spec_burst(fa, pa, qmm, eng, SamplingParams, "8d prompt lookup, gamma 4", requests)
    add(m["launches"])
    m["exactness"] = check_spec_exactness(eng, reqs, layers, reference, "8d")
    log(f"8d: {json.dumps(m)}")
    out["ngram"] = m
    eng.stop()
    out["launches"] = launches
    return out


def phase_spec_server(eng, OpenAIServer) -> dict:
    """8e: ``/metrics`` through the OpenAI server on the self-draft engine
    (idle, after a gauge refresh): the speculation series equal to the
    engine's stats and counters (the server stops the engine)."""
    from modal_examples_tpu_torch.observability import catalog as C

    srv = OpenAIServer(eng, model_name="llama2-7b", port=0).start()
    try:
        settle(eng)
        eng._metrics_wall = 0.0
        eng._refresh_gauges()
        _, _, text = http(f"http://{srv.host}:{srv.port}", "/metrics")
        series = {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
                  if line.startswith("mtpu_spec_")}
        st = eng.stats
        # the fallback counter exists once a round fell back; the γ and
        # tokens-a-round gauges are windows of the refresh throttle, logged
        want = {C.SPEC_PROPOSED_TOTAL: st.spec_proposed, C.SPEC_ACCEPTED_TOTAL: st.spec_accepted,
                C.SPEC_ACCEPTANCE_RATE: st.acceptance_rate(), C.SPEC_FALLBACK_TOTAL: eng._spec_fallbacks}
        log(f"8e /metrics speculation series {series}, stats {want}")
        for name, v in want.items():
            got = series.get(name, 0.0 if name == C.SPEC_FALLBACK_TOTAL else None)
            if got is None or abs(got - v) > 1e-4 * max(1.0, abs(v)):
                raise AssertionError(f"8e /metrics {name} = {got}, stats {v}")
    finally:
        srv.stop()
    return {"series": series}


# -- phase 9 ----------------------------------------------------------------------

#: the MMDiT's joint attention at SD3-Medium's shape: 154 text tokens (CLIP-L
#: and CLIP-G's 77 each) before 1024 image patches (a 64 x 64 latent in 2 x 2
#: patches), 24 heads of 64, full attention
JOINT_SHAPE = dict(B=1, H=24, S=154 + 1024, D=64)
#: the text-to-image run of ``bench.py``'s image child: 4 Euler steps at
#: guidance 4, one image, then the SD3 VAE's decode to 512 x 512
T2I_STEPS, T2I_GUIDANCE, T2I_TEXT = 4, 4.0, 154
T2I_TIMED = 3  # images timed after one warm-up
#: the K1 pipeline's final latents against the plain-attention pipeline's:
#: cosine of the latents, cosine of their departure from the shared noise
#: (the part the model computed), max |diff| / max |plain|. The last two
#: exist because a planted fault in the last of 24 blocks barely moves the
#: latents' cosine, which the shared noise dominates
T2I_COSINE_MIN, T2I_STEP_COSINE_MIN, T2I_REL_MAX = 0.99, 0.999, 5e-2
#: the port's card run against its CPU run, f32 models (bert, whisper, CLIP)
CPU_AGREE = 1e-4
#: ``bench.py``'s embedding batch (B, S) and transcription batch (chunks,
#: frames, greedy tokens)
EMBED_BATCH = (256, 512)
ASR_BATCH = (8, 3000, 64)


def cosine(a, b) -> float:
    return torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0).item()


def to_cpu(params):
    from modal_examples_tpu_torch.utils import tree as tree_util

    return tree_util.map(lambda t: t.cpu(), params)


def joint_k1(fa, card: str) -> dict:
    """9a: K1 at the joint shape against its plain version on the card,
    bitwise run to run, a planted fault (the ragged last key tile, keys
    1152..1177, left out) refused; device, single, back-to-back, plain and
    SDPA times and the operation bound."""
    B, H, S, D = (JOINT_SHAPE[k] for k in "BHSD")
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = flash_case(gen, B, H, H, S, S, D)
    scale = D**-0.5
    o, lse = fa.flash_forward_cuda(q, k, v, causal=False, sm_scale=scale)
    o2, _ = fa.flash_forward_cuda(q, k, v, causal=False, sm_scale=scale)
    want, want_lse = fa.flash_forward_plain(q, k, v, causal=False, sm_scale=scale)
    err, err_lse = max_err(o, want), max_err(lse, want_lse)
    tile = S // 128 * 128  # the kernel's key tiles are 128 rows at D=64: keys tile.. are the ragged last one
    fault, _ = fa.flash_forward_cuda(q, k[:, :, :tile].contiguous(), v[:, :, :tile].contiguous(), causal=False,
                                     sm_scale=scale)
    fault_err = max_err(fault, want)
    log(f"9a K1 at the joint shape B={B} H={H} S={S} D={D} (full): max|o-plain|={err:.3g} max|lse-plain|="
        f"{err_lse:.3g}, bitwise run to run {torch.equal(o, o2)}; planted fault (keys {tile}..{S - 1} left out): "
        f"max|o-plain|={fault_err:.3g}; SDPA max|o-plain|={max_err(sdpa(q, k, v, False), want):.3g}")
    if not (err <= TOL["flash_fwd"] and err_lse <= 1e-3 and torch.equal(o, o2)):
        raise AssertionError(f"K1 at the joint shape: error {err}, lse {err_lse}, bitwise {torch.equal(o, o2)}")
    if not fault_err > TOL["flash_fwd"]:
        raise AssertionError(f"the check does not see the ragged last key tile left out: {fault_err}")
    flops = 4 * B * H * S * S * D
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4  # q, k, v in; o, lse out
    kernel = lambda: fa.flash_forward_cuda(q, k, v, causal=False, sm_scale=scale)  # noqa: E731
    library = lambda: sdpa(q, k, v, False)  # noqa: E731
    out = dict(
        shape=f"B={B} H={H} S={S} (154 text + 1024 image) D={D}, full attention", max_abs_err=err,
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: fa.flash_forward_plain(q, k, v, causal=False, sm_scale=scale), reps=5),
        bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
        bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
        library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library), library_device_ms=device_ms(library),
    )
    log(f"9a K1 at the joint shape ({card}): device {fmt_ms(out['device_ms'])} ms, single {out['ms']:.4f}, "
        f"back-to-back {out['ms_b2b']:.4f}; plain {out['plain_ms']:.4f}; SDPA device "
        f"{fmt_ms(out['library_device_ms'])}, back-to-back "
        f"{out['library_ms_b2b']:.4f}; bound {out['bound_ms']:.4f} by {out['bound_by']}")
    return out


def open_the_gates(params: dict, seed: int) -> None:
    """Draw the MMDiT's zero-initialised leaves (every modulation, the final
    projection) from a seeded N(0, 0.02) in place: with them zero every
    block is the identity, the velocity is exactly zero, and no check could
    see the attention."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    groups = [params["blocks"], params.get("last_block", {}), params]
    for group in groups:
        for name, t in group.items():
            if isinstance(t, torch.Tensor) and ("_mod_" in name or name.startswith("final_")):
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda", dtype=torch.float32).mul_(0.02))


def text_to_image(fa, diffusion, vae, reference, tree_util, card: str) -> dict:
    """9b: ``bench.py``'s text-to-image run at SD3-Medium's shape in bf16
    through ``mmdit_sample`` and ``vae.decode``: K1 launched 2 forwards x
    steps x blocks times, counters zeroed just before; the image finite in
    [-1, 1]; the latents against the same run with the reference's plain
    attention products (same weights, same noise) within the ``T2I_*``
    limits, and a planted fault (the last block's attention output zeroed)
    refused by the same check; img/s over 3 images after a warm-up,
    sampling and decode timed by CUDA events."""
    mcfg = diffusion.MMDiTConfig.sd3_shape()
    vcfg = dataclasses.replace(vae.VAEConfig.sd3_shape(), dtype="bfloat16")
    t0 = time.monotonic()
    params = diffusion.mmdit_init(mcfg, seed=0, device="cuda")
    open_the_gates(params, seed=1)
    vparams = vae.init_params(vcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_util.leaves(params))
    log(f"9b MMDiT sd3_shape ({n_params / 1e9:.3f}B parameters, bf16) and SD3 VAE drawn in {time.monotonic() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    text = torch.randn((1, T2I_TEXT, mcfg.text_dim), generator=gen, device="cuda").to(torch.bfloat16)
    pooled = torch.randn((1, mcfg.pooled_dim), generator=gen, device="cuda").to(torch.bfloat16)
    null_t, null_p = torch.zeros_like(text), torch.zeros_like(pooled)
    shape = (1, mcfg.img_size, mcfg.img_size, mcfg.channels)
    noise = torch.randn(shape, generator=gen, device="cuda")

    def sample(noise):
        return diffusion.mmdit_sample(params, text, pooled, null_t, null_p, mcfg, steps=T2I_STEPS,
                                      guidance=T2I_GUIDANCE, noise=noise)

    fa.launches = 0
    lat = sample(noise)
    img = vae.decode(vparams, lat.to(torch.bfloat16), vcfg)
    torch.cuda.synchronize()
    launches = fa.launches
    want = 2 * T2I_STEPS * mcfg.n_layers
    px = mcfg.img_size * vcfg.downscale
    log(f"9b K1 launches for one image: {launches} (2 forwards x {T2I_STEPS} steps x {mcfg.n_layers} blocks = {want}); "
        f"image {tuple(img.shape)} {img.dtype}, range [{img.min().item():.4f}, {img.max().item():.4f}]")
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times for one image, not {want}")
    if img.shape != (1, px, px, 3) or not torch.isfinite(img).all() or img.abs().max().item() > 1.0:
        raise AssertionError(f"the image is not finite {px}x{px} RGB in [-1, 1]: {tuple(img.shape)}")
    real = fa.flash_attention

    def with_attention(fn):
        fa.flash_attention = fn
        lat = sample(noise)
        fa.flash_attention = real
        return lat

    plain = with_attention(lambda q, k, v, causal=True, sm_scale=None: reference.attention(q, k, v, causal=causal))
    calls = itertools.count()

    def last_block_zeroed(q, k, v, causal=True, sm_scale=None):
        o = real(q, k, v, causal, sm_scale)
        return torch.zeros_like(o) if next(calls) % mcfg.n_layers == mcfg.n_layers - 1 else o

    faulty = with_attention(last_block_zeroed)

    def agreement(x):
        return dict(cosine=cosine(x, plain), cosine_of_the_step=cosine(x - noise, plain - noise),
                    max_rel_err=max_err(x, plain) / plain.abs().max().item())

    ok, bad = agreement(lat), agreement(faulty)
    log(f"9b latents, K1 against the reference's plain products: {ok}; planted fault (the last block's attention "
        f"output zeroed): {bad}")
    def agrees(r):
        return (r["cosine"] >= T2I_COSINE_MIN and r["cosine_of_the_step"] >= T2I_STEP_COSINE_MIN
                and r["max_rel_err"] <= T2I_REL_MAX)

    if not agrees(ok):
        raise AssertionError(f"the K1 pipeline disagrees with the plain-attention pipeline: {ok}")
    if agrees(bad):
        raise AssertionError(f"the agreement check does not see the last block's attention zeroed: {bad}")
    del plain, faulty
    sampling, decoding = [], []
    for i in range(T2I_TIMED):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        lat = sample(torch.randn(shape, generator=gen, device="cuda"))
        marks[1].record()
        img = vae.decode(vparams, lat.to(torch.bfloat16), vcfg)
        marks[2].record()
        marks[2].synchronize()
        sampling.append(marks[0].elapsed_time(marks[1]))
        decoding.append(marks[1].elapsed_time(marks[2]))
        if not torch.isfinite(img).all():
            raise AssertionError(f"timed image {i} is not finite")
    total_s = (sum(sampling) + sum(decoding)) / 1e3
    out = dict(
        k1_launches_per_image=launches, agreement=ok, fault=bad, images=T2I_TIMED,
        img_per_s=T2I_TIMED / total_s, sampling_ms=sampling, decode_ms=decoding,
        resolution=f"{px}x{px}", steps=T2I_STEPS, guidance=T2I_GUIDANCE,
    )
    log(f"9b text-to-image ({card}): {out['img_per_s']:.4f} img/s over {T2I_TIMED} images; sampling ms "
        f"{sampling}, VAE decode ms {decoding}")
    del params, vparams
    return out


def embeddings(bert, card: str) -> dict:
    """9c: bge-small (f32) at ``bench.py``'s B=256, S=512: unit-norm
    embeddings; half of each row masked gives the embedding of the first
    half alone (and moves it); two rows against the port's CPU run; tok/s."""
    cfg = bert.BertConfig.bge_small_en()
    params = bert.init_params(cfg, seed=0, device="cuda")
    B, S = EMBED_BATCH
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    emb = bert.embed(params, toks, mask, cfg)
    norm_err = (torch.linalg.vector_norm(emb, dim=-1) - 1).abs().max().item()
    half = mask.clone()
    half[:, S // 2:] = 0
    padded = bert.embed(params, toks, half, cfg)
    alone = bert.embed(params, toks[:, : S // 2].contiguous(), None, cfg)
    pad_err, moved = max_err(padded, alone), max_err(padded, emb)
    cpu = bert.embed(to_cpu(params), toks[:2].cpu(), mask[:2].cpu(), cfg)
    cpu_err = max_err(emb[:2].cpu(), cpu)
    log(f"9c bge-small B={B} S={S}: max|norm-1|={norm_err:.3g}; half masked against the first half alone "
        f"{pad_err:.3g} (moved {moved:.3g} from the unmasked); two rows against the CPU run {cpu_err:.3g}")
    if not (norm_err <= 1e-5 and pad_err <= 1e-5 and moved > 1e-3 and cpu_err <= CPU_AGREE):
        raise AssertionError(f"bge-small: norm {norm_err}, padding {pad_err}, moved {moved}, cpu {cpu_err}")
    ms = time_ms(lambda: bert.embed(params, toks, mask, cfg), reps=5, warmup=1)
    out = dict(batch=B, seq=S, ms=ms, tok_per_s=B * S / (ms / 1e3), cpu_max_abs=cpu_err)
    log(f"9c bge-small embeddings ({card}): {out['tok_per_s']:.0f} tok/s ({ms:.2f} ms a batch of {B} x {S})")
    return out


def first_divergence(toks, ref, margins, tol: float) -> dict:
    """Greedy tokens against a reference run's: equal up to the first
    position where they differ, and there the reference's top-2 logit margin
    within ``tol`` (a near-tie); the positions after it are not compared."""
    toks, ref = toks.tolist(), ref.tolist()
    for p, (a, b) in enumerate(zip(toks, ref)):
        if a != b:
            if margins[p] > tol:
                raise AssertionError(f"greedy token {p}: {a} against {b} with a top-2 margin of {margins[p]}")
            return dict(compared=p + 1, equal=p, near_tie_at=p, margin=margins[p], not_compared=len(ref) - p - 1)
    return dict(compared=len(ref), equal=len(ref), near_tie_at=None, not_compared=0)


def transcription(whisper, audio, StreamingTranscriber, card: str) -> dict:
    """9d: whisper-base (f32), 8 chunks x 3000 frames, 64 greedy tokens, as
    ``bench.py``'s ASR child: one chunk's encoder states (cuDNN's TF32 left
    on around the call: the entry point turns it off for its own
    convolutions) and tokens against the port's CPU run (tokens by the
    margin rule); ``align_tokens`` monotone and within the audio; a
    ``StreamingTranscriber`` over 5 s of tones in 0.5 s pieces, then a
    flush; x-realtime."""
    cfg = whisper.WhisperConfig.base()
    params = whisper.init_params(cfg, seed=0, device="cuda")
    B, T, n_tok = ASR_BATCH
    mel = torch.randn((B, T, cfg.n_mels), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    cpu_params = to_cpu(params)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    states = whisper.encode(params, mel[:1], cfg)
    torch.backends.cudnn.allow_tf32 = allow
    enc_err = max_err(states.cpu(), whisper.encode(cpu_params, mel[:1].cpu(), cfg))
    toks = whisper.greedy_transcribe(params, mel, cfg, bos_id=0, eos_id=1, max_tokens=n_tok)
    ref = whisper.greedy_transcribe(cpu_params, mel[:1].cpu(), cfg, bos_id=0, eos_id=1, max_tokens=n_tok)[0]
    buf = torch.cat([torch.zeros(1, dtype=torch.int32), ref])[None]
    logits = whisper.decode(cpu_params, buf, whisper.encode(cpu_params, mel[:1].cpu(), cfg), cfg)[0, :-1]
    top2 = logits.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    tokens = first_divergence(toks[0].cpu(), ref, margins, tol=1e-3)
    times = whisper.align_tokens(params, mel[:1], toks[:1], cfg, bos_id=0)
    monotone = bool((np.diff(times[0, :, 0]) >= 0).all() and (times[0, :, 1] >= times[0, :, 0]).all())
    within = float(times.max()) <= T * 0.01 + 1e-6
    log(f"9d whisper-base: encoder states against the CPU run {enc_err:.3g} (cuDNN TF32 allowed outside); chunk 0's "
        f"tokens against the CPU run {tokens}; align_tokens monotone {monotone}, last end {float(times.max()):.2f}s "
        f"of {T * 0.01:.0f}s")
    if not (enc_err <= CPU_AGREE and monotone and within):
        raise AssertionError(f"whisper-base: encoder {enc_err}, monotone {monotone}, within the audio {within}")
    wave = audio.synth_tone_audio([440.0, 880.0, 1320.0], seconds=5.0)
    st = StreamingTranscriber(params, cfg, bos_id=0, eos_id=1)
    t0 = time.monotonic()
    updates = [st.feed(wave[i:i + 8000]) for i in range(0, len(wave), 8000)]
    final = st.flush()
    stream_s = time.monotonic() - t0
    log(f"9d streaming: {sum(u is not None for u in updates)} updates over 10 pieces and a flush in {stream_s:.2f}s; "
        f"{len(final.committed_text)} characters committed")
    ms = time_ms(lambda: whisper.greedy_transcribe(params, mel, cfg, bos_id=0, eos_id=1, max_tokens=n_tok), reps=2,
                 warmup=1)
    audio_s = B * T * audio.HOP / audio.SAMPLE_RATE  # 10 ms a frame
    out = dict(chunks=B, frames=T, tokens=n_tok, ms=ms, x_realtime=audio_s / (ms / 1e3), encoder_cpu_max_abs=enc_err,
               greedy=tokens, streaming_s=stream_s)
    log(f"9d whisper-base transcription ({card}): {out['x_realtime']:.1f}x realtime ({ms:.1f} ms for {audio_s:.0f} s "
        "of audio)")
    return out


def clip_text_states(clip_text) -> dict:
    """9e: CLIP-L on 2 x 77 tokens: hidden and pooled states against the
    port's CPU run."""
    cfg = clip_text.CLIPTextConfig.clip_l()
    params = clip_text.init_params(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size - 1, (2, cfg.max_len), generator=torch.Generator(device="cuda").manual_seed(5),
                         device="cuda")
    toks[0, 20] = toks[1, 76] = cfg.eos_token_id
    hidden, pooled = clip_text.forward(params, toks, cfg)
    h_cpu, p_cpu = clip_text.forward(to_cpu(params), toks.cpu(), cfg)
    errs = dict(hidden=max_err(hidden.cpu(), h_cpu), pooled=max_err(pooled.cpu(), p_cpu))
    log(f"9e CLIP-L 2 x 77 tokens against the CPU run: {errs}")
    if not max(errs.values()) <= CPU_AGREE:
        raise AssertionError(f"CLIP-L disagrees with its CPU run: {errs}")
    return errs


def phase_inference_workloads(fa, reference, card: str) -> dict:
    """Phase 9: the north star's other inference workloads at full width on
    random weights from seeds (9a-9e)."""
    from modal_examples_tpu_torch.models import bert, clip_text, diffusion, vae, whisper
    from modal_examples_tpu_torch.serving.streaming_asr import StreamingTranscriber
    from modal_examples_tpu_torch.utils import audio
    from modal_examples_tpu_torch.utils import tree as tree_util

    out = {"joint_k1": joint_k1(fa, card)}
    out["text_to_image"] = text_to_image(fa, diffusion, vae, reference, tree_util, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["embeddings"] = embeddings(bert, card)
    out["transcription"] = transcription(whisper, audio, StreamingTranscriber, card)
    out["clip_l"] = clip_text_states(clip_text)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 10 ---------------------------------------------------------------------

#: 10a: K7 at Mixtral's expert products, (K, N) of gate/up and of down, at a
#: decode step's M and the prefill batch's
EXPERT_SHAPES = ((4096, 14336), (14336, 4096))
EXPERT_MS = (8, 2048)
#: 10b: the bf16 Mixtral at full width and this depth (about 23.7 GB)
MOE_BF16_LAYERS = 8
#: routing, held two ways: the served choices against the plain f32 routing
#: of the same layer inputs must agree wherever the k-th and (k+1)-th
#: probabilities differ by more than ROUTE_TIE (nearer pairs are ties,
#: counted); against the free-running reference's routing (its own f32
#: hidden states, which the served bf16 ones drift from: a token whose
#: choice flips at one layer drifts at the next), at least ROUTE_AGREE of the
#: choices must agree (a router choosing 2 of 8 at random would share 1 in
#: 28), the disagreements counted with their largest margin
ROUTE_TIE = 1e-6
ROUTE_AGREE = 0.8
#: the served logits' contract against the plain reference (as phases 3-8)
CONTRACT = {"cosine_min": 0.999, "max_rel_err": 5e-2}


def expert_k7() -> dict:
    """10a: K7 at ``EXPERT_SHAPES`` x ``EXPERT_MS`` against ``qmm_plain``
    (within 1e-3 of its largest value), bitwise run to run, a planted fault
    (the last 128 columns of x zeroed: the last K tile of either path left
    out) refused; timed single, back to back and by device time over two
    weight copies in turn (each 58.7 MB, past the 50 MB L2), beside the bf16
    GEMM over the dequantized weights."""
    from modal_examples_tpu_torch.models.quantize import dequantize_weight, quantize_weight
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(14)
    out, worst = {}, 0.0
    for K, N in EXPERT_SHAPES:
        weights = [quantize_weight(torch.randn(K, N, generator=gen, device="cuda")) for _ in range(2)]
        bf16 = [dequantize_weight(w, torch.bfloat16) for w in weights]
        w = weights[0]
        for M in EXPERT_MS:
            x = rand_bf16(gen, M, K)
            want = qmm.qmm_plain(x, w.q, w.scale)
            got = qmm.qmm_cuda(x, w.q, w.scale)
            tol = 1e-3 * want.abs().max().item()
            err = max_err(got, want)
            cut = x.clone()
            cut[:, -128:] = 0
            fault = max_err(qmm.qmm_cuda(cut, w.q, w.scale), want)
            label = f"M={M} K={K} N={N}"
            if not err <= tol:
                raise AssertionError(f"10a K7 {label}: max abs err {err} over {tol}")
            if not torch.equal(got, qmm.qmm_cuda(x, w.q, w.scale)):
                raise AssertionError(f"10a K7 {label}: two launches differ")
            if not fault > tol:
                raise AssertionError(f"10a K7 {label}: the planted fault (last K tile left out) passed: {fault}")
            flops, nbytes = 2 * M * N * K, M * K * 2 + K * N + N * 4 + M * N * 4  # x, q, scale in; f32 out
            kernel = cycling([lambda w=w: qmm.qmm_cuda(x, w.q, w.scale) for w in weights])
            bf16_mm = cycling([lambda wd=wd: torch.mm(x, wd) for wd in bf16])
            out[label] = dict(
                path=qmm.kernel_path(x, w.q), max_abs_err=err, rel_err=err / want.abs().max().item(),
                fault_err=fault, ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=time_ms(lambda: qmm.qmm_plain(x, w.q, w.scale), reps=5),
                bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
                bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
                bf16_mm_ms=time_ms(bf16_mm), bf16_mm_ms_b2b=back_to_back_ms(bf16_mm),
                bf16_mm_device_ms=device_ms(bf16_mm),
            )
            worst = max(worst, err)
            log(f"10a K7 {label}: {json.dumps(out[label])}")
        del weights, bf16, w
    return {"shapes": out, "max_abs_err": worst}


class RouteWatch:
    """Records the served path's routing while it is entered: each call of
    ``moe._nodrop_weights`` (one a layer) as (layer input [T, D], router,
    top-k indices [T, k])."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.inner = self.moe._nodrop_weights

        def recording(x, router, top_k):
            got = self.inner(x, router, top_k)
            self.calls.append((x, router, got[0]))
            return got

        self.moe._nodrop_weights = recording
        return self

    def __exit__(self, *exc):
        self.moe._nodrop_weights = self.inner


def plain_route(x, router, k: int):
    """The reference's routing of ``x`` [T, D] in plain f32: (probs, top-k indices)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    return probs, torch.topk(probs, k, dim=-1).indices


def compare_routes(served: list, ref: list, k: int) -> dict:
    """Expert choices (sets of k a token) of ``served`` against ``ref``,
    both lists of (probs or None, top-k indices) a layer: agreements, ties
    (the reference's k-th and (k+1)-th probabilities within ``ROUTE_TIE``)
    and the disagreements outside the ties with the largest margin among
    them."""
    agree = ties = tie_disagree = far_disagree = 0
    far_margin = 0.0
    for s_idx, (r_probs, r_idx) in zip(served, ref, strict=True):
        same = (s_idx.sort(dim=-1).values == r_idx.sort(dim=-1).values).all(dim=-1)
        top = r_probs.sort(dim=-1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        tie = margin <= ROUTE_TIE
        agree += int(same.sum())
        ties += int(tie.sum())
        tie_disagree += int((~same & tie).sum())
        far_disagree += int((~same & ~tie).sum())
        if (~same & ~tie).any():
            far_margin = max(far_margin, margin[~same & ~tie].max().item())
    n = agree + tie_disagree + far_disagree
    return {"choices": n, "agree": agree, "agree_share": agree / n, "ties": ties, "tie_disagree": tie_disagree,
            "far_disagree": far_disagree, "far_disagree_max_margin": far_margin}


def moe_dense_check(eng, llama, layers, reference, moe, label: str) -> dict:
    """Prefill + one decode step (the engine's structure,
    :func:`served_logits`) against the plain reference with f32 expert
    activations. Held at the contract: the reference routed through the
    experts the served path chose (each token's choices a layer, weighted by
    the reference's own f32 probabilities), so that a near-tie which the
    served bf16 hidden state breaks the other way does not swap an expert
    between the two. The choices themselves are held against the plain
    routing of the same layer inputs (equal outside ties within
    ``ROUTE_TIE``). Reported: the free-running reference (its own routing
    from its own hidden states), and the share of its choices the served
    path makes (held at ``ROUTE_AGREE``). Then the port's ``forward`` on the
    card over the 99 tokens, held the same way."""
    cfg = eng.cfg
    L, k = cfg.n_layers, cfg.top_k_experts
    with RouteWatch(moe) as watch:
        toks, got, n_cached = served_logits(eng, llama)
    if len(watch.calls) != 2 * L:
        raise AssertionError(f"{label}: {len(watch.calls)} routed layers served, want {2 * L}")
    pre, dec = watch.calls[:L], watch.calls[L:]
    served = {"prefill": [(x[:99], r, i[:99]) for x, r, i in pre], "decode": dec}
    forced = [torch.cat([p[2][:99], d[2]]) for p, d in zip(pre, dec)]  # positions 0..98, then 99
    errs = {}
    for name, n, nc in (("prefill", 99, 0), ("decode", 100, n_cached)):
        ref = dense_reference_logits(eng.params, cfg, toks[:, :n], layers, reference, nc,
                                     forced=[f[:n] for f in forced])
        errs[name] = logits_vs(f"{label} {name} (the served routing)", got[name], ref, cfg.vocab_size)
        own: list = []
        free = dense_reference_logits(eng.params, cfg, toks[:, :n], layers, reference, nc, routes=own)
        errs[name]["own_routing"] = logits_vs(f"{label} {name} (the reference's own routing, not held)", got[name],
                                              free, cfg.vocab_size, hold=False)
        rows = slice(0, 99) if name == "prefill" else slice(99, 100)
        ids = [i for _, _, i in served[name]]
        errs[name]["routing"] = {
            "same_input": compare_routes(ids, [plain_route(x, r, k) for x, r, _ in served[name]], k),
            "vs_reference": compare_routes(ids, [(p[rows], i[rows]) for p, i in own], k),
        }
        r = errs[name]["routing"]
        if r["same_input"]["far_disagree"] or r["vs_reference"]["agree_share"] < ROUTE_AGREE:
            raise AssertionError(f"{label} {name}: expert choices disagree: {r}")
    with RouteWatch(moe) as watch:
        fwd = llama.forward(eng.params, toks[:, :99].long(), cfg)[:, -1]
    ref = dense_reference_logits(eng.params, cfg, toks[:, :99], layers, reference,
                                 forced=[i for _, _, i in watch.calls])
    errs["forward"] = logits_vs(f"{label} forward on the card (its routing)", fwd, ref, cfg.vocab_size)
    log(f"{label} dense check: {json.dumps(errs)}")
    return errs


def phase_moe_bf16(fa, pa, qmm, llama, layers, reference, moe, LLMEngine, SamplingParams) -> dict:
    """10b: ``mixtral_8x7b()`` at ``MOE_BF16_LAYERS`` layers, bf16, random
    weights from a seed. The ragged (K2) engine serves phase 3's burst at
    N=1 and N=8 (greedy and seeded rows identical), the write-then-attend
    (K4) engine at N=1, counters zeroed just before each burst and read just
    after; each structure's prefill + decode step against the plain
    reference, with the routing and the card's ``forward``."""
    from modal_examples_tpu_torch.models.quantize import param_bytes

    cfg = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(), n_layers=MOE_BF16_LAYERS)
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=14, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.monotonic() - t0, "params_b": cfg.param_count / 1e9, "weight_gb": param_bytes(params) / 1e9}
    log(f"10b mixtral bf16 at {cfg.n_layers} layers: init {out['init_s']:.1f}s, {out['params_b']:.2f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    L = cfg.n_layers
    for impl, kernel in (("xla", "paged_decode"), ("pallas-writeback", "paged_decode_writeback")):
        eng = LLMEngine(cfg, params, paged_impl=impl, **SERVE_KW)
        eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
        runs = {}
        for n in ((1, 8) if impl == "xla" else (1,)):
            eng.decode_steps = n
            zero_counts(fa, pa, qmm)
            reqs, m = serve_burst(eng, SamplingParams, f"10b mixtral bf16 {impl}, N={n}")
            m["launches"] = counts = spec_counts(fa, pa, qmm)
            steps = m["dispatched_steps"]
            other = "paged_decode_writeback" if kernel == "paged_decode" else "paged_decode"
            if counts[kernel] != L * steps or counts[other] or counts["quantized_matmul"]:
                raise AssertionError(f"10b {impl} N={n} launches {counts}: want {L} x {steps} {kernel} alone")
            folded = L * steps if impl != "xla" else 0  # the writeback step's rows written by K4 itself
            if counts["flash_fwd"] < 1 or counts["kv_scatter"] < 1 or counts["paged_decode_writeback_folded"] != folded:
                raise AssertionError(f"10b {impl} N={n} launches {counts}: want K1, K3 and {folded} folded K4")
            runs[n] = (reqs, m)
        if impl == "xla":
            runs[8][1]["rows_held"] = check_same_tokens(runs[8][0], runs[1][0], "10b mixtral bf16, N=8 against N=1")
        out[impl] = {f"n{n}": m for n, (_, m) in runs.items()}
        out[impl]["dense_check"] = moe_dense_check(eng, llama, layers, reference, moe, f"10b mixtral bf16 {impl}")
        eng.stop()
        del eng
    launches = {}
    for impl in ("xla", "pallas-writeback"):
        for m in out[impl].values():
            for k, v in m.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    del params
    return out


def phase_moe_int8(fa, pa, qmm, llama, layers, reference, moe, build_engine, OpenAIServer, SamplingParams,
                   keep: dict) -> dict:
    """10c: ``build_engine("mixtral-8x7b", quantization="int8")`` at full
    depth with an int8 cache; weight bytes at most 0.52 of the bf16 count;
    phase 3's burst with the counters zeroed just before and read just after
    (K2-int8 n_layers x dispatched steps, K7 (4 + 3 E) n_layers + 1 a pass);
    the dense check over the same int8 weights and cache rows; the burst
    again through ``OpenAIServer``; the peak memory under the card's. The
    engine stops at the end, and its int8 tree goes to ``keep["params"]``
    (phase 18 trains over it)."""
    from modal_examples_tpu_torch.models.quantize import param_bytes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = build_engine("mixtral-8x7b", quantization="int8", kv_dtype="int8", **SERVE_KW)
    torch.cuda.synchronize()
    cfg, L, E = eng.cfg, eng.cfg.n_layers, eng.cfg.n_experts
    w_bytes = param_bytes(eng.params)
    out = {"init_s": time.monotonic() - t0, "params_b": cfg.param_count / 1e9, "weight_gb": w_bytes / 1e9,
           "weight_ratio": w_bytes / (2 * cfg.param_count), "cache_gb": eng.cache.bytes() / 1e9,
           "plan": eng.impl_plan}
    log(f"10c mixtral-8x7b int8: {json.dumps(out)}")
    if not out["weight_ratio"] <= 0.52:
        raise AssertionError(f"10c int8 weights {out['weight_ratio']} of the bf16 count, over 0.52")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    zero_counts(fa, pa, qmm)
    reqs, m = serve_burst(eng, SamplingParams, "10c mixtral-8x7b int8")
    counts = spec_counts(fa, pa, qmm)
    steps, per_pass = m["dispatched_steps"], (4 + 3 * E) * L + 1  # attention's four, three an expert; lm_head
    if counts["paged_decode_int8"] != L * steps:
        raise AssertionError(f"10c launches {counts}: want {L} x {steps} K2-int8")
    if counts["paged_decode"] or counts["kv_scatter"] or counts["paged_decode_writeback"]:
        raise AssertionError(f"10c launched a bf16 cache kernel: {counts}")
    if counts["kv_scatter_int8"] < 1 or counts["flash_fwd"] < 1:
        raise AssertionError(f"10c: a kernel of the int8 path never launched: {counts}")
    if counts["quantized_matmul"] % per_pass or counts["quantized_matmul"] < per_pass * (steps + 1):
        raise AssertionError(f"10c K7 launches {counts['quantized_matmul']}: want a multiple of {per_pass}, "
                             f"at least {per_pass} x ({steps} steps + a prefill)")
    m.update(launches=counts, k7_per_decode_step=per_pass,
             prefill_passes=counts["quantized_matmul"] // per_pass - steps)
    out["burst"] = m
    log(f"10c burst: {json.dumps(m)}")
    out["dense_check"] = moe_dense_check(eng, llama, layers, reference, moe, "10c mixtral-8x7b int8")
    out["server"] = moe_server_burst(eng, OpenAIServer, SamplingParams, reqs)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["card_gb"] = torch.cuda.get_device_properties(0).total_memory / 1e9
    if not out["peak_gb"] < out["card_gb"]:
        raise AssertionError(f"10c peak memory {out['peak_gb']} GB not under the card's {out['card_gb']} GB")
    log(f"10c mixtral-8x7b int8: burst {m['burst_tok_per_s']:.1f} tok/s, decode {m['decode_tok_per_s']:.1f} tok/s, "
        f"TTFT median {m['ttft_s_median']:.3f}s, K7 {per_pass} a decode step, peak {out['peak_gb']:.2f} GB "
        f"of {out['card_gb']:.2f} GB")
    eng.stop()
    keep["params"] = eng.params
    return out


def moe_server_burst(eng, OpenAIServer, SamplingParams, direct: list) -> dict:
    """Phase 3's 8 requests at once through ``/v1/completions``, streamed
    with usage (one thread each): every answer a 200 ending in ``[DONE]``
    with a finish reason that its token count explains (the usage chunk
    counts generated tokens), every page back after; the greedy and seeded
    rows' texts beside the direct burst's (logged: the arrival order
    changes the prefill groups). Stops the server and the engine."""
    import concurrent.futures

    srv = OpenAIServer(eng, model_name="mixtral-8x7b", port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        bodies = [{"prompt": p, "max_tokens": sp.max_tokens, "temperature": sp.temperature, "top_p": sp.top_p,
                   "stream": True, "stream_options": {"include_usage": True},
                   **({} if sp.seed is None else {"seed": sp.seed})} for p, sp in make_requests(SamplingParams)]
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            answers = list(pool.map(lambda b: http(base, "/v1/completions", b), bodies))
        wall = time.monotonic() - t0
        same = held = tokens = 0
        for body, (status, _, text), ref in zip(bodies, answers, direct):
            events = [e for e in text.split("\n\n") if e]
            if status != 200 or events[-1] != "data: [DONE]":
                raise AssertionError(f"10c server: {status} {text[-300:]}")
            chunks = [json.loads(e[len("data: "):]) for e in events[:-1]]
            n = chunks[-1]["usage"]["completion_tokens"]
            finish = [c["choices"][0]["finish_reason"] for c in chunks if c["choices"]][-1]
            got = "".join(c["choices"][0]["text"] for c in chunks if c["choices"])
            if not ((finish == "length" and n == body["max_tokens"]) or (finish == "stop" and n <= body["max_tokens"])):
                raise AssertionError(f"10c server: finish {finish} with {n} tokens for max_tokens={body['max_tokens']}")
            tokens += n
            if body["temperature"] == 0.0 or "seed" in body:
                held += 1
                same += got == eng.tokenizer.decode(ref.generated_tokens)
        settle(eng)
        check_pages_returned(eng, "10c server")
        out = {"requests": len(bodies), "wall_s": wall, "tok_per_s": tokens / wall, "completion_tokens": tokens,
               "greedy_and_seeded_rows": held, "rows_equal_to_the_direct_burst": same}
        log(f"10c server burst: {json.dumps(out)}")
        return out
    finally:
        srv.stop()


def phase_mixtral(fa, pa, llama, layers, reference, LLMEngine, OpenAIServer, SamplingParams, keep: dict) -> dict:
    """Phase 10: Mixtral-8x7B through the port's entry points (after
    training, every earlier tree freed); 10c's int8 tree is left in
    ``keep["params"]``."""
    from modal_examples_tpu_torch.models import moe
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm
    from modal_examples_tpu_torch.serving.engine import build_engine

    out = {"expert_k7": expert_k7()}
    log("phase 10a K7 at the expert shapes: ok")
    gc.collect()
    torch.cuda.empty_cache()
    out["bf16"] = phase_moe_bf16(fa, pa, qmm, llama, layers, reference, moe, LLMEngine, SamplingParams)
    log("phase 10b mixtral bf16: ok")
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = phase_moe_int8(fa, pa, qmm, llama, layers, reference, moe, build_engine, OpenAIServer,
                                 SamplingParams, keep)
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(out["bf16"]["launches"])
    for k, v in out["int8"]["burst"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


# -- phase 18: Mixtral LoRA training on the capacity experts --------------------------

#: attention-only adapters, as the reference's MoE tests restrict them
MOE_LORA_TARGETS = ("wq", "wk", "wv", "wo")
#: the reference tests' loss: cross entropy + 0.01 x the mean aux loss
MOE_AUX_WEIGHT = 0.01
#: the gradient check's cut depth (the unplanned formula's widened stacks,
#: 5.6 GB a layer, fit beside the tree there)
MOE_GRAD_LAYERS = 2
#: 1 warm-up and 2 timed steps (cut for time, as phase 17's)
MOE_TRAIN_STEPS = 3


class unplanned_experts:
    """Within it, the capacity path runs the reference's einsums over every
    widened stack at once (``moe.capacity_experts_plain``) in place of
    ``moe.CapacityExperts``: the gradient check's comparison path."""

    def __init__(self, moe):
        self.moe, self.apply = moe, moe.CapacityExperts.apply

    def __enter__(self):
        self.moe.CapacityExperts.apply = self.moe.capacity_experts_plain

    def __exit__(self, *exc):
        self.moe.CapacityExperts.apply = self.apply


class RouteReplay:
    """The capacity path's top-k choices (``moe._topk``, called once a layer
    in order): ``recording()`` keeps a run's, ``replaying()`` makes the next
    run take them (each choice's probability from that run's own router, so
    the gradient through the router stays), ``comparing()`` lets a run route
    freely and counts the tokens whose choices differ from the recorded
    ones. Routing is discontinuous: a bf16 rounding in the attention output
    flips a near-tie and moves that token (and, past a full expert, the
    ones behind it) to other experts, as phase 10's ``RouteWatch`` found
    for serving."""

    def __init__(self, moe):
        self.moe, self.topk, self.choices, self.flips = moe, moe._topk, [], 0

    def _run(self, fn):
        class _Ctx:
            def __enter__(ctx):
                self.calls = 0
                self.moe._topk = fn

            def __exit__(ctx, *exc):
                self.moe._topk = self.topk
        return _Ctx()

    def recording(self):
        self.choices = []

        def record(probs, k):
            vals, idx = self.topk(probs, k)
            self.choices.append(idx.detach())
            return vals, idx
        return self._run(record)

    def replaying(self):
        def replay(probs, k):
            idx = self.choices[self.calls]
            self.calls += 1
            return probs.gather(-1, idx), idx
        return self._run(replay)

    def comparing(self):
        self.flips = 0

        def compare(probs, k):
            vals, idx = self.topk(probs, k)
            self.flips += int((idx != self.choices[self.calls]).any(dim=-1).sum())
            self.calls += 1
            return vals, idx
        return self._run(compare)


class SavedWatch:
    """``torch.autograd.graph.saved_tensors_hooks`` that records the dtype
    and element count of every tensor saved for the backward (the tensor
    itself is handed back, nothing kept)."""

    def __init__(self):
        self.saved = []
        self.hooks = torch.autograd.graph.saved_tensors_hooks(self.pack, lambda t: t)

    def pack(self, t):
        self.saved.append((t.dtype, t.numel(), tuple(t.shape)))
        return t

    def __enter__(self):
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)


def moe_lora_setup(llama, lora, training, params, steps: int, auxes: list):
    """Phase 18's training path: Mixtral-8x7B over the frozen int8
    ``params``, rank-16 LoRA on ``MOE_LORA_TARGETS``, ``steps`` batches of
    B=2 x S=512 random tokens, cross entropy + ``MOE_AUX_WEIGHT`` x aux from
    ``forward(moe_impl="capacity", return_aux=True)`` (each aux appended to
    ``auxes``). Returns (cfg, lcfg, adapters, batches, loss_over), where
    ``loss_over(base)`` is the loss over ``base`` (a cut of ``params``)."""
    cfg = llama.LlamaConfig.mixtral_8x7b()
    lcfg = lora.LoRAConfig(rank=16, targets=MOE_LORA_TARGETS)
    B, S = 2, 512
    tok_gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=tok_gen, device="cuda")}
               for _ in range(steps)]

    def loss_over(base):
        def loss_fn(ad, batch, attn_impl="flash"):
            logits, aux = llama.forward(base, batch["tokens"], cfg, attn_impl=attn_impl, lora=ad,
                                        lora_scale=lcfg.scale, moe_impl="capacity", return_aux=True)
            auxes.append(aux.detach())
            return training.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:]) + MOE_AUX_WEIGHT * aux
        return loss_fn

    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), params, lcfg)
    return cfg, lcfg, adapters, batches, loss_over


def phase_moe_training(fa, qmm, llama, lora, training, moe, params, card: str) -> dict:
    """Phase 18 (after phase 10, over 10c's int8 tree): Mixtral-8x7B at full
    width and depth, frozen int8 base (random weights from phase 10c's
    seed), rank-16 LoRA on the attention projections (f32 adapters), B=2 x
    S=512 random tokens, the loss of the reference's MoE tests: cross
    entropy + 0.01 x aux from ``forward(moe_impl="capacity",
    return_aux=True)``, the experts at capacity factor 1.5 through
    ``moe.CapacityExperts`` (f32 products, TF32 off). First, at a cut depth
    of ``MOE_GRAD_LAYERS``, the adapter gradients against the same step
    through the unplanned einsums (``unplanned_experts``) and the same flash
    attention, and against the unplanned einsums with ``attn_impl="xla"``,
    both routed through the first run's top-2 choices (``RouteReplay``; the
    f32 products summed in another order are enough to move a near-tie in
    the second layer): cosine per target at least ``GRAD_COSINE_MIN`` each;
    the second comparison routed freely is logged with the tokens it
    rerouted. Then, counters zeroed, 1 warm-up and 2
    timed ``Trainer`` steps at full depth: K1, K5 and K6 n_layers times a
    step, K7 on the attention projections (and lm_head), losses finite; the
    first step's saved tensors watched: none is a floating tensor shaped as
    an expert stack or one expert's matrix, nor of a stack's E x D x F
    elements; the peak memory under the card's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    auxes = []
    cfg, lcfg, adapters, batches, loss_over = moe_lora_setup(llama, lora, training, params, MOE_TRAIN_STEPS, auxes)
    B, S = batches[0]["tokens"].shape
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    log(f"phase 18 mixtral-8x7b LoRA ({card}): int8 base resident, {base_gb:.2f} GB allocated; LoRA rank "
        f"{lcfg.rank} on {lcfg.targets}, B={B} S={S}, capacity factor {cfg.expert_capacity_factor}")
    # the gradient check at a cut depth: the planned experts and the flash
    # kernels against the unplanned einsums and the plain attention
    t0 = time.monotonic()
    cut = {**params, "layers": params["layers"][:MOE_GRAD_LAYERS]}
    cut_adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), cut, lcfg)
    routes = RouteReplay(moe)
    with routes.recording():
        planned = adapter_grads(loss_over(cut), cut_adapters, batches[0], "flash")
    with unplanned_experts(moe), routes.replaying():
        same_attention = adapter_grads(loss_over(cut), cut_adapters, batches[0], "flash")
    plan = compare_adapter_grads(planned, same_attention, lcfg.targets,
                                 f"planned vs unplanned experts, both through flash, depth {MOE_GRAD_LAYERS}, "
                                 f"routed as the planned run")
    with unplanned_experts(moe), routes.replaying():
        unplanned = adapter_grads(loss_over(cut), cut_adapters, batches[0], "xla")
    grads = compare_adapter_grads(planned, unplanned, lcfg.targets,
                                  f"planned experts + flash vs unplanned einsums + xla, depth {MOE_GRAD_LAYERS}, "
                                  f"routed as the planned run")
    with unplanned_experts(moe), routes.comparing():
        free = adapter_grads(loss_over(cut), cut_adapters, batches[0], "xla")
    free_cos = {t: torch.nn.functional.cosine_similarity(planned[f"{t}_b"].flatten(), free[f"{t}_b"].flatten(),
                                                         dim=0).item() for t in lcfg.targets}
    log(f"phase 18 the same comparison routed freely (logged, not held): cosine {free_cos}, tokens whose top-2 "
        f"moved {routes.flips} of {B * S * MOE_GRAD_LAYERS} token-layers")
    grad_s = time.monotonic() - t0
    del cut, cut_adapters, planned, same_attention, unplanned, free
    gc.collect()
    torch.cuda.empty_cache()

    if any(v.dtype != torch.float32 for v in adapters["layers"].values()):
        raise AssertionError("adapters over an int8 base must be f32")
    trainer = training.Trainer(loss_over(params), training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = qmm.qmm_launches = 0
    auxes.clear()
    step_s, losses, per_step = [], [], []
    watch = SavedWatch()
    for i, batch in enumerate(batches):
        before = (fa.launches, fa.dq_launches, fa.dkv_launches, qmm.qmm_launches)
        t1 = time.monotonic()
        if i == 0:
            with watch:
                state, m = trainer.train_step(state, batch)
        else:
            state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        losses.append(m["loss"].item())
        per_step.append([a - b for a, b in zip((fa.launches, fa.dq_launches, fa.dkv_launches, qmm.qmm_launches),
                                               before)])
    peak = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    L, D, Fd, E = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    stack_shapes = {(E, D, Fd), (E, Fd, D), (D, Fd), (Fd, D)}  # a stack, or one expert's matrix
    widened = [x for x in watch.saved if x[0].is_floating_point and (x[2] in stack_shapes or x[1] == E * D * Fd)]
    k7_want = len(lcfg.targets) * L + int(hasattr(params.get("lm_head"), "scale"))
    counts = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches,
              "quantized_matmul": qmm.qmm_launches}
    log(f"phase 18 steps: loss {losses}, aux {[a.item() for a in auxes]}, step s {step_s}, launches a step "
        f"(K1, K5, K6, K7) {per_step}; saved tensors {len(watch.saved)}, shaped as an expert stack or matrix "
        f"{widened}")
    if per_step != [[L, L, L, k7_want]] * len(batches):
        raise AssertionError(f"phase 18 launches a step {per_step}: want K1, K5, K6 {L} each and K7 {k7_want}")
    if widened:
        raise AssertionError(f"phase 18 saved a widened expert matrix for the backward: {widened}")
    if not all(math.isfinite(x) for x in losses + [a.item() for a in auxes]):
        raise AssertionError(f"non-finite MoE LoRA loss or aux: {losses}, {auxes}")
    moved = {t: state.params["layers"][f"{t}_b"].abs().max().item() for t in lcfg.targets}
    if min(moved.values()) <= 0:
        raise AssertionError(f"b adapters did not move off zero: {moved}")
    if not peak < card_gb:
        raise AssertionError(f"phase 18 peak {peak:.2f} GB not under the card's {card_gb:.2f} GB")
    step_med = statistics.median(step_s[1:])
    out = {
        "card": card, "train_tok_per_s": B * S / step_med, "step_ms_median": 1e3 * step_med,
        "step_ms": [1e3 * x for x in step_s], "losses": losses, "aux": [a.item() for a in auxes],
        "launches_a_step": dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "quantized_matmul"),
                                    per_step[-1])),
        "peak_gb": peak, "card_gb": card_gb, "base_gb": base_gb, "saved_tensors": len(watch.saved),
        "saved_gb": sum(n * (4 if dt == torch.float32 else 2 if dt in (torch.bfloat16, torch.float16) else 1)
                        for dt, n, _ in watch.saved) / 1e9,
        "grad_check_s": grad_s, "grad_check": grads, "launches": counts,
        "grad_check_free": {"cosine": free_cos, "tokens_rerouted": routes.flips}, "grad_check_plan": plan,
        "cut": f"1 + {MOE_TRAIN_STEPS - 1} steps (time); the gradient check at depth {MOE_GRAD_LAYERS}",
    }
    log(f"phase 18 metrics ({card}): {out['train_tok_per_s']:.1f} tok/s, step {out['step_ms_median']:.1f} ms "
        f"(median of {MOE_TRAIN_STEPS - 1} after 1 warm-up), peak {peak:.2f} GB of {card_gb:.2f} GB; "
        f"{json.dumps(out)}")
    return out


# -- phase 11 ---------------------------------------------------------------------

#: 11a's warm round trip: no-op method calls, median
WARM_CALLS = 20

APP_ENGINE = '''
"""Phase 3's engine for chip_smoke.py's phase 11 containers: Llama-2-7B from
phase 3's seed (bf16, 8 slots, buckets 128/256/512, pages of 16, decode
block 8), warmed by one short request as phase 3 warms it."""
import time

import torch

from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama
from modal_examples_tpu_torch.ops import flash_attention as fa
from modal_examples_tpu_torch.ops import paged_attention as pa


def build(t: dict):
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t["weights_at"] = time.time()
    eng = LLMEngine(cfg, params, max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512), prefill_batch=4,
                    decode_block=8, seed=0, device="cuda")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    t["engine_at"] = time.time()
    return eng


def zero_counts() -> None:
    fa.launches = pa.decode_launches = pa.scatter_launches = 0


def counts() -> dict:
    return {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
'''

APP_FUNCTIONS = '''
"""chip_smoke.py phase 11a and 11d: functions and a Cls on the card, and
the CLI's entry point."""
import json
import os
import time

import torch

import modal_examples_tpu_torch as mtpu

app = mtpu.App("smoke-functions")
#: phase 2's first K1 case, the engine's prefill batch: B, H, S, D
K1_SHAPE = (4, 32, 512, 128)


@app.function(gpu="H100", max_containers=1, timeout=600)
def k1_check(seed: int) -> dict:
    """K1 against its plain version at K1_SHAPE, in this container."""
    from modal_examples_tpu_torch.ops import _build
    from modal_examples_tpu_torch.ops import flash_attention as fa

    B, H, S, D = K1_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    o, _ = fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)
    torch.cuda.synchronize()
    want, _ = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5)
    return {"card": torch.cuda.get_device_name(0), "max_abs_err": (o.float() - want.float()).abs().max().item(),
            "k1_launches": fa.launches, "compiled": list(_build.compiled), "pid": os.getpid()}


@app.function(max_containers=1, timeout=300)
def cpu_probe() -> dict:
    return {"cuda_available": torch.cuda.is_available(), "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES")}


@app.function(gpu="H100:2", timeout=300)
def two_cards() -> str:
    return "ran on two cards"


@app.cls(gpu="H100", max_containers=1, timeout=600)
class Probe:
    @mtpu.enter()
    def load(self):
        """A CUDA context and every kernel library of the checkout loaded."""
        from modal_examples_tpu_torch.ops import _build

        self.entered_at = time.time()
        torch.zeros(1, device="cuda")
        for name in _build.kernel_names():
            _build.load(name)
        self.ready_at = time.time()

    @mtpu.method()
    def boot(self) -> dict:
        from modal_examples_tpu_torch.ops import _build

        return {"entered_at": self.entered_at, "ready_at": self.ready_at, "returned_at": time.time(),
                "compiled": list(_build.compiled)}

    @mtpu.method()
    def ping(self) -> int:
        return 0


@app.local_entrypoint()
def main(seed: int = 0):
    print("11d " + json.dumps(k1_check.remote(seed)))
'''

APP_SERVER = '''
"""chip_smoke.py phase 11b: Llama-2-7B served by an @app.server container."""
import os
import threading
import time

import torch

import modal_examples_tpu_torch as mtpu
from smoke_engine import build, counts, zero_counts

app = mtpu.App("smoke-server")
PORT = @PORT@
EXIT_MARK = @EXIT_MARK@


@app.server(port=PORT, gpu="H100", startup_timeout=600, timeout=600)
class LlamaServer:
    @mtpu.enter()
    def start(self):
        from modal_examples_tpu_torch import OpenAIServer

        self.boot = {"entered_at": time.time()}
        self.engine = build(self.boot)
        # the requests the server submits, for their tokens and their TTFT on
        # the engine's clock; while a burst is held, they are parked until
        # the burst is whole and then queued together
        self.requests, self.burst, self.lock = [], 0, threading.Lock()
        submit = self.engine.submit_request

        def recording_submit(req):
            with self.lock:
                self.requests.append(req)
                if len(self.requests) < self.burst:
                    return req  # parked
                batch = sorted(self.requests, key=lambda r: len(r.prompt_tokens)) if self.burst else [req]
                self.burst = 0
                for r in batch:
                    submit(r)
            return req

        self.engine.submit_request = recording_submit
        self.server = OpenAIServer(self.engine, model_name="llama2-7b", port=PORT).start()
        self.boot["server_at"] = time.time()

    @mtpu.method()
    def zero_counts(self, hold: int = 0) -> None:
        """Counts to 0 and no request recorded. ``hold``: the next ``hold``
        requests are queued together, shortest prompt first, as phase 3's
        direct burst queues its 8, so the engine finds them at one tick;
        otherwise each is queued as it arrives."""
        zero_counts()
        with self.lock:
            self.requests.clear()
            self.burst = hold

    @mtpu.method()
    def report(self) -> dict:
        from modal_examples_tpu_torch.ops import _build

        reqs = sorted(self.requests, key=lambda r: r.created)
        return {**self.boot, "launches": counts(), "peak_bytes": torch.cuda.max_memory_allocated(),
                "rows": [{"prompt": r.prompt, "tokens": list(r.generated_tokens), "n_generated": r.n_generated,
                          "finish_reason": r.finish_reason, "ttft_s": r.first_token_at - r.created} for r in reqs],
                "compiled": list(_build.compiled), "card": torch.cuda.get_device_name(0), "pid": os.getpid()}

    @mtpu.exit()
    def stop(self):
        self.server.stop()  # and the engine
        with open(EXIT_MARK, "w") as f:
            f.write("stopped")
'''

APP_CLS = '''
"""chip_smoke.py phase 11c: a @app.cls whose @enter loads the engine once."""
import os
import time

import modal_examples_tpu_torch as mtpu
from smoke_engine import build, counts, zero_counts

app = mtpu.App("smoke-cls")
#: @enter calls in this process (one: the container serves every input)
ENTERS = []


@app.cls(gpu="H100", max_containers=1, timeout=600)
class Generator:
    @mtpu.enter()
    def load(self):
        ENTERS.append(time.time())
        self.boot = {"entered_at": time.time()}
        self.engine = build(self.boot)

    @mtpu.method()
    @mtpu.batched(max_batch_size=8, wait_ms=500)
    def generate(self, prompts: list, params: list) -> list:
        """The batch's requests submitted back to back, as phase 3's direct
        burst submits its 8, then streamed."""
        from modal_examples_tpu_torch import SamplingParams

        reqs = [self.engine.make_request(p, SamplingParams(**sp)) for p, sp in zip(prompts, params)]
        for r in reqs:
            self.engine.submit_request(r)
        texts = ["".join(self.engine.stream(r)) for r in reqs]
        return [{"tokens": list(r.generated_tokens), "finish_reason": r.finish_reason, "text": t,
                 "enters": len(ENTERS), "pid": os.getpid()} for r, t in zip(reqs, texts)]

    @mtpu.method()
    def zero_counts(self) -> None:
        zero_counts()

    @mtpu.method()
    def counts(self) -> dict:
        return counts()
'''


def write_app(dirpath: Path, name: str, template: str, **values) -> Path:
    text = template
    for key, value in values.items():
        text = text.replace(f"@{key}@", repr(value))
    path = dirpath / f"{name}.py"
    path.write_text(text.lstrip())
    return path


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stream_completion(base: str, body: dict) -> dict:
    """One streamed ``/v1/completions`` with usage: text, finish and
    completion tokens."""
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    t0 = time.monotonic()
    chunks = []
    with urllib.request.urlopen(req, timeout=600) as r:
        status = r.status
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                chunks.append(None)
                break
            chunks.append(json.loads(line[len("data: "):]))
    if status != 200 or not chunks or chunks[-1] is not None:
        raise AssertionError(f"11b: status {status}, stream not ended by [DONE]")
    chunks = chunks[:-1]
    return {"text": "".join(c["choices"][0]["text"] for c in chunks if c["choices"]),
            "finish": [c["choices"][0]["finish_reason"] for c in chunks if c["choices"]][-1],
            "completion_tokens": chunks[-1]["usage"]["completion_tokens"], "wall_s": time.monotonic() - t0}


def served_rows(bodies: list, got: list, rows: list, direct: list, decode, label: str, hold: bool) -> dict:
    """Each streamed answer beside the container's own request for its prompt
    (its tokens' text, their count in the usage, its finish), then each
    greedy and seeded row's tokens and finish beside phase 3's direct burst:
    held with ``hold``, counted without it (arrival order sets the prefill
    groups there). Returns the rows compared and the rows equal."""
    by_prompt = {r["prompt"]: r for r in rows}
    if sorted(by_prompt) != sorted(b["prompt"] for b in bodies):
        raise AssertionError(f"{label}: the container served {len(rows)} requests, not the burst's {len(bodies)}")
    compared = equal = 0
    for i, (body, g, (tokens, finish)) in enumerate(zip(bodies, got, direct)):
        r = by_prompt[body["prompt"]]
        if (g["text"], g["completion_tokens"], g["finish"]) != (decode(r["tokens"]), r["n_generated"],
                                                                r["finish_reason"]):
            raise AssertionError(f"{label} row {i}: the streamed answer ({g['completion_tokens']} tokens, "
                                 f"{g['finish']}) is not the container's request ({r['n_generated']}, "
                                 f"{r['finish_reason']})")
        if body["temperature"] > 0 and "seed" not in body:
            continue
        compared += 1
        equal += (r["tokens"], r["finish_reason"]) == (list(tokens), finish)
    log(f"{label}: {equal} of {compared} greedy and seeded rows' tokens equal to phase 3's direct burst")
    if hold and equal != compared:
        raise AssertionError(f"{label}: {compared - equal} greedy or seeded rows' tokens differ from phase 3's "
                             f"direct burst")
    return {"greedy_and_seeded_rows": compared, "rows_equal_to_the_direct_burst": equal}


def phase11_functions(mtpu, load_module_from_path, path: Path) -> dict:
    """11a: ``@app.function(gpu="H100")`` through ``.remote``, ``.map`` over
    4 inputs and ``.spawn``, each K1 against its plain version in the
    container; a function without ``gpu=`` sees no card; ``gpu="H100:2"``
    fails at boot naming the spec; a Cls's cold boot split and a warm
    round trip."""
    mod = load_module_from_path(str(path))
    app = mod.app
    out = {}
    with app.run():
        # the two side containers boot while the card's first one does
        probe = mod.cpu_probe.spawn()
        two = mod.two_cards.spawn()
        t0 = time.monotonic()
        first = mod.k1_check.remote(0)
        out["first_remote_s"] = time.monotonic() - t0
        rows = [first, *mod.k1_check.map(range(1, 5)), mod.k1_check.spawn(5).get(timeout=600)]
        for i, r in enumerate(rows):
            if not (r["max_abs_err"] <= TOL["flash_fwd"] and r["k1_launches"] > 0 and not r["compiled"]):
                raise AssertionError(f"11a call {i}: {r}")
        if len({r["pid"] for r in rows}) != 1 or [r["k1_launches"] for r in rows] != list(range(1, 7)):
            raise AssertionError(f"11a: one container (max_containers=1) should run K1 once a call: {rows}")
        out["k1"] = {"card": first["card"], "calls": len(rows), "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "container_launches": rows[-1]["k1_launches"], "compiled_in_container": first["compiled"]}
        p = probe.get(timeout=300)
        if p["cuda_available"] or p["CUDA_VISIBLE_DEVICES"] != "":
            raise AssertionError(f"11a: a container without gpu= sees a card: {p}")
        out["cpu_container"] = p
        try:
            two.get(timeout=300)
        except RuntimeError as e:
            if "H100:2" not in str(e):
                raise
            out["two_cards_boot_error"] = str(e)
        else:
            raise AssertionError("11a: a gpu='H100:2' function ran on a one-card host")
        t_submit = time.time()
        boot = mod.Probe().boot.remote()
        t_done = time.time()
        if boot["compiled"]:
            raise AssertionError(f"11a: the Probe container compiled {boot['compiled']}")
        out["cold_boot_s"] = {"spawn_and_import": boot["entered_at"] - t_submit,
                              "enter": boot["ready_at"] - boot["entered_at"],
                              "first_result": t_done - boot["ready_at"], "total": t_done - t_submit}
        warm = []
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            mod.Probe().ping.remote()
            warm.append(time.perf_counter() - t0)
        out["warm_round_trip_ms"] = statistics.median(warm) * 1e3
    log(f"11a functions: {json.dumps(out)}")
    return out


def phase11_server(mtpu, load_module_from_path, path: Path, exit_mark: Path, port: int, SamplingParams,
                   direct: list, decode) -> dict:
    """11b: ``@app.server(gpu="H100")`` serving Llama-2-7B at full width;
    phase 3's 8 requests as concurrent streamed ``/v1/completions``, twice:
    queued as they arrive (rows counted), then held and queued together as
    the direct burst queues them (rows held). The counts go to 0 just before
    each burst and are read just after it."""
    import concurrent.futures

    mod = load_module_from_path(str(path))
    app = mod.app
    handle = app.registered_servers["LlamaServer"]
    bodies = [{"prompt": p, "max_tokens": sp.max_tokens, "temperature": sp.temperature, "top_p": sp.top_p,
               "stream": True, "stream_options": {"include_usage": True},
               **({} if sp.seed is None else {"seed": sp.seed})} for p, sp in make_requests(SamplingParams)]
    bursts = {}
    with app.run():
        t0 = time.time()
        base = handle.serve()
        ready = time.time()
        server = mtpu.Cls.from_name("smoke-server", "LlamaServer")()
        for name, hold in (("arrival", False), ("one_tick", True)):
            server.zero_counts.remote(len(bodies) if hold else 0)
            t1 = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
                got = list(pool.map(lambda b: stream_completion(base, b), bodies))
            wall = time.monotonic() - t1
            rep = server.report.remote()
            for body, g in zip(bodies, got):
                n = g["completion_tokens"]
                if not ((g["finish"] == "length" and n == body["max_tokens"]) or
                        (g["finish"] == "stop" and n <= body["max_tokens"])):
                    raise AssertionError(f"11b: finish {g['finish']} with {n} tokens for "
                                         f"max_tokens={body['max_tokens']}")
            rows = served_rows(bodies, got, rep["rows"], direct, decode, f"11b server ({name})", hold)
            if min(rep["launches"].values()) <= 0 or rep["compiled"]:
                raise AssertionError(f"11b: the container's launches {rep['launches']}, compiled {rep['compiled']}")
            ttfts = [r["ttft_s"] for r in rep["rows"]]
            bursts[name] = {**rows, "launches": rep["launches"],
                            "burst_tok_per_s": sum(g["completion_tokens"] for g in got) / wall, "wall_s": wall,
                            "ttft_s_median": statistics.median(ttfts), "ttft_s_first_arrival": ttfts[0],
                            "ttft_s_max": max(ttfts)}
        handle.stop()
        if not exit_mark.exists() or port_accepts(port):
            raise AssertionError("11b: @exit did not stop the server, or its port still accepts")
    launches = {k: sum(b["launches"][k] for b in bursts.values()) for k in bursts["arrival"]["launches"]}
    out = {"card": rep["card"], **bursts, "launches": launches,
           "boot_s": {"spawn_and_import": rep["entered_at"] - t0, "weights": rep["weights_at"] - rep["entered_at"],
                      "engine": rep["engine_at"] - rep["weights_at"], "server": rep["server_at"] - rep["engine_at"],
                      "port_ready": ready - t0},
           "peak_gb": rep["peak_bytes"] / 1e9}
    log(f"11b server: {json.dumps(out)}")
    return out


def port_accepts(port: int) -> bool:
    """Whether a connection to the port on this host is accepted."""
    import socket

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=1.0):
            return True
    except OSError:
        return False


def phase11_cls(load_module_from_path, path: Path, SamplingParams, direct: list) -> dict:
    """11c: ``@app.cls(gpu="H100")``: ``.remote`` on the first request, then
    ``.map`` over phase 3's 8, batched into one engine burst."""
    mod = load_module_from_path(str(path))
    reqs = make_requests(SamplingParams)
    params = [{"max_tokens": sp.max_tokens, "temperature": sp.temperature, "seed": sp.seed, "top_p": sp.top_p}
              for _, sp in reqs]
    with mod.app.run():
        gen = mod.Generator()
        t0 = time.monotonic()
        first = gen.generate.remote(reqs[0][0], params[0])
        first_s = time.monotonic() - t0
        gen.zero_counts.remote()
        t0 = time.monotonic()
        rows = list(gen.generate.map([p for p, _ in reqs], params))
        wall = time.monotonic() - t0
        launches = gen.counts.remote()
    held = 0
    for i, (r, sp, (tokens, finish)) in enumerate(zip([first, *rows], [params[0], *params], [direct[0], *direct])):
        if sp["temperature"] > 0 and sp["seed"] is None:
            continue
        if (r["tokens"], r["finish_reason"]) != (list(tokens), finish):
            raise AssertionError(f"11c row {i}: tokens differ from phase 3's direct burst")
        held += 1
    if {r["enters"] for r in [first, *rows]} != {1} or len({r["pid"] for r in [first, *rows]}) != 1:
        raise AssertionError("11c: @enter ran more than once, or the inputs ran in more than one container")
    if min(launches.values()) <= 0:
        raise AssertionError(f"11c: the container's launches {launches}")
    out = {"rows_held": held, "launches": launches, "remote_s": first_s, "map_wall_s": wall,
           "map_tok_per_s": sum(len(r["tokens"]) for r in rows) / wall}
    log(f"11c cls: {json.dumps(out)}")
    return out


def phase11_cli(path: Path) -> dict:
    """11d: ``python -m modal_examples_tpu_torch run`` on 11a's file: exit 0
    and the entry point's result printed."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "modal_examples_tpu_torch", "run", str(path), "--seed", "7"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    lines = [line for line in proc.stdout.splitlines() if line.startswith("11d ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"11d: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    r = json.loads(lines[-1][4:])
    if not (r["max_abs_err"] <= TOL["flash_fwd"] and r["k1_launches"] > 0):
        raise AssertionError(f"11d: {r}")
    out = {"seconds": time.monotonic() - t0, "max_abs_err": r["max_abs_err"], "k1_launches": r["k1_launches"]}
    log(f"11d cli: {json.dumps(out)}")
    return out


def phase_serverless(SamplingParams, direct: list, decode) -> dict:
    """Phase 11: the serverless surface on the card, through the port's own
    entry points (``app.run()``, ``ServerHandle.serve()``, the CLI). The app
    files go into a temporary directory; each imports
    ``modal_examples_tpu_torch`` and nothing of the JAX package. The parent
    built every kernel in phase 1, so no container runs nvcc."""
    import tempfile

    import modal_examples_tpu_torch as mtpu
    from modal_examples_tpu_torch.core.app import load_module_from_path

    out = {}
    with tempfile.TemporaryDirectory(prefix="smoke-apps-", dir=ROOT / "build") as d:
        d = Path(d)
        port = free_port()
        write_app(d, "smoke_engine", APP_ENGINE)
        functions = write_app(d, "smoke_functions", APP_FUNCTIONS)
        server = write_app(d, "smoke_server", APP_SERVER, PORT=port, EXIT_MARK=str(d / "exit_mark"))
        cls_app = write_app(d, "smoke_cls", APP_CLS)
        t0 = time.monotonic()
        out["functions"] = phase11_functions(mtpu, load_module_from_path, functions)
        out["server"] = phase11_server(mtpu, load_module_from_path, server, d / "exit_mark", port, SamplingParams,
                                       direct, decode)
        out["cls"] = phase11_cls(load_module_from_path, cls_app, SamplingParams, direct)
        out["cli"] = phase11_cli(functions)
        out["seconds"] = time.monotonic() - t0
    launches = {k: out["server"]["launches"][k] + out["cls"]["launches"][k] for k in out["server"]["launches"]}
    launches["flash_fwd"] += out["functions"]["k1"]["container_launches"] + out["cli"]["k1_launches"]
    out["container_launches"] = launches
    return out


# -- phase 14 ---------------------------------------------------------------------

#: 14a: Llama-2-7B width at this depth in the snapshot-enabled class (2.1 GB
#: of bf16 weights: embedding and head, 2 x 262 MB, and 4 x 404 MB of layers)
SNAP_DEPTH = 4
#: 14a: phase 3's first prompts, served greedy on each boot
SNAP_PROMPTS = 4
#: 14b: the fine-tune's steps before the interruption, and in all
LORA_FAIL_AFTER, LORA_STEPS = 2, 4
#: 14b: relative loss tolerance when phase 2 finds the flash backward
#: kernels not bitwise from launch to launch
LORA_LOSS_RTOL = 1e-3
#: 14c: seconds of seeded audio, sent in chunks of this many seconds
ASR_AUDIO_S, ASR_CHUNK_S = 8.0, 0.5

APP_SNAPSHOT = '''
"""chip_smoke.py phase 14a: a snapshot-enabled GPU class. Its snap hook draws
Llama-2-7B-width weights at depth @DEPTH@ on the card from phase 3's seed; its
other hook loads the kernel libraries and builds the engine."""
import contextlib
import dataclasses
import os
import time

import torch

import modal_examples_tpu_torch as mtpu

app = mtpu.App("smoke-snapshot")
PROGRESS = @PROGRESS@


@app.cls(gpu="H100", enable_memory_snapshot=True, max_containers=1, timeout=900)
class Engine:
    @mtpu.enter(snap=True)
    def load(self):
        from modal_examples_tpu_torch.models import llama

        runs = mtpu.Dict.from_name(PROGRESS)
        runs["snap_hook_runs"] = runs.get("snap_hook_runs", 0) + 1  # counted from inside the container
        self.cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=@DEPTH@)
        self.params = llama.init_params(self.cfg, seed=0, device="cuda")
        torch.cuda.synchronize()

    @mtpu.enter()
    def start(self):
        from modal_examples_tpu_torch import LLMEngine, SamplingParams
        from modal_examples_tpu_torch.ops import _build

        t0 = time.perf_counter()
        for name in _build.kernel_names():
            _build.load(name)
        self.kernels_s = time.perf_counter() - t0
        self.engine = LLMEngine(self.cfg, self.params, max_slots=8, max_model_len=1024,
                                prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8, seed=0,
                                device="cuda")
        self.engine.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))

    @mtpu.method()
    def generate(self, prompts: list, max_tokens: list) -> dict:
        """The prompts greedy, submitted back to back; K1, K2 and K3 counted
        from 0 around the burst."""
        from modal_examples_tpu_torch import SamplingParams
        from modal_examples_tpu_torch.core.executor import boot_info
        from modal_examples_tpu_torch.ops import _build
        from modal_examples_tpu_torch.ops import flash_attention as fa
        from modal_examples_tpu_torch.ops import paged_attention as pa

        fa.launches = pa.decode_launches = pa.scatter_launches = 0
        reqs = [self.engine.make_request(p, SamplingParams(max_tokens=n, temperature=0.0))
                for p, n in zip(prompts, max_tokens)]
        for r in reqs:
            self.engine.submit_request(r)
        for r in reqs:
            "".join(self.engine.stream(r))
        return {"rows": [(list(r.generated_tokens), r.finish_reason) for r in reqs],
                "launches": {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches,
                             "kv_scatter": pa.scatter_launches},
                "boot": boot_info(), "kernels_s": self.kernels_s, "compiled": list(_build.compiled),
                "snap_hook_runs": mtpu.Dict.from_name(PROGRESS).get("snap_hook_runs", 0),
                "card": torch.cuda.get_device_name(0), "pid": os.getpid()}
'''

APP_LORA = '''
"""A resumable LoRA fine-tune through the platform layer, after the JAX
package's examples/06_gpu_and_ml/llm-finetuning/lora_finetune.py: adapters
on all seven projections, checkpoints on a Volume (reloaded before the scan
for checkpoints, committed after each save), a retry in a fresh container
that resumes from the latest step, progress through a Dict. Written by
chip_smoke.py (phase 14b: Llama-2-7B on the card) and by
tests/test_torch_lora_resume.py (the example's tiny f32 config on the CPU)."""
import hashlib
import time

import torch

import modal_examples_tpu_torch as mtpu

SETUP = @SETUP@

app = mtpu.App("lora-resume")
ckpt_vol = mtpu.Volume.from_name(SETUP["volume"], create_if_missing=True)


def config():
    from modal_examples_tpu_torch.models import llama

    if SETUP["config"] == "llama2_7b":
        return llama.LlamaConfig.llama2_7b()
    return llama.LlamaConfig(**SETUP["config"])


def digest(tree) -> str:
    """sha256 over the bytes of every tensor of ``tree``, in its order."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    h = hashlib.sha256()
    for t in tree_util.leaves(tree):
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@app.function(gpu=SETUP["gpu"], volumes={SETUP["mount"]: ckpt_vol}, timeout=900,
              retries=mtpu.Retries(initial_delay=0.0, max_retries=1), single_use_containers=True)
def finetune(run: str, max_steps: int, fail_after: int = 0) -> dict:
    """Train ``run`` to ``max_steps``, from its latest checkpoint if it has
    one. A run started from scratch with ``fail_after`` saves and commits
    at that step, then raises (the retry resumes there)."""
    from modal_examples_tpu_torch.models import llama, lora
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.training import (CheckpointManager, Trainer, TrainState, cross_entropy_loss,
                                                   make_optimizer)

    device = SETUP["device"]
    if SETUP.get("threads"):  # the CPU's GEMMs, summed in one order from process to process
        torch.set_num_threads(SETUP["threads"])
    progress = mtpu.Dict.from_name(SETUP["progress"])
    cfg = config()
    base = llama.init_params(cfg, seed=0, device=device)
    lcfg = lora.LoRAConfig(rank=SETUP["rank"])
    adapters = lora.init_lora(torch.Generator(device=device).manual_seed(0), base, lcfg)
    B, S = SETUP["batch"]

    def batch_at(step: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(1 + step)
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device),
                "mask": torch.ones((B, S), device=device)}

    def loss_fn(ad, batch):
        logits = llama.forward(base, batch["tokens"], cfg, attn_impl="flash", lora=ad, lora_scale=lcfg.scale)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    trainer = Trainer(loss_fn, make_optimizer(SETUP["lr"]))
    state = trainer.init_state(adapters)
    # reload first: a retry's fresh container must see the dead attempt's
    # commits before it scans for checkpoints
    ckpt_vol.reload()
    ckpts = CheckpointManager(f"{SETUP['mount']}/{run}", keep_n=2, volume=ckpt_vol)
    start, loaded = 0, None
    if ckpts.latest_step() is not None:
        start = ckpts.latest_step()
        restored = ckpts.restore({"adapters": state.params, "opt": state.opt_state})
        state = TrainState(params=restored["adapters"], opt_state=restored["opt"], step=start)
        loaded = digest(state.params)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    losses, step_s = {}, []
    for step in range(start, max_steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch_at(step))
        losses[step + 1] = m["loss"].item()  # waits for the step
        step_s.append(time.perf_counter() - t0)
        progress[f"{run}/step"] = step + 1
        if step + 1 == fail_after and start == 0:
            t0 = time.perf_counter()
            path = ckpts.save(step + 1, {"adapters": state.params, "opt": state.opt_state})
            progress[f"{run}/interrupted"] = {
                "step": step + 1, "digest": digest(state.params), "losses": losses, "step_s": step_s,
                "save_s": time.perf_counter() - t0, "bytes": sum(p.stat().st_size for p in path.rglob("*")),
                "launches": {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                             "flash_bwd_dkv": fa.dkv_launches}}
            raise RuntimeError(f"interrupted after the step {step + 1} checkpoint")
    ckpts.save(max_steps, {"adapters": state.params, "opt": state.opt_state})
    return {"resumed_from": start, "loaded_digest": loaded, "final_digest": digest(state.params),
            "losses": losses, "step_s": step_s,
            "launches": {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}}
'''

APP_ASR = '''
"""chip_smoke.py phase 14c: streaming ASR over a websocket. The handler runs
in the gateway's process, on the whisper-base weights the caller puts in
MODEL; binary frames are float32 PCM, the text frame "end" flushes."""
import numpy as np

import modal_examples_tpu_torch as mtpu
from modal_examples_tpu_torch.serving.streaming_asr import StreamingTranscriber
from modal_examples_tpu_torch.web.websocket import ConnectionClosed

app = mtpu.App("smoke-asr")
MODEL = {}


@app.function()
@mtpu.websocket_endpoint()
def transcribe_ws(ws):
    t = StreamingTranscriber(MODEL["params"], MODEL["cfg"], bos_id=0, eos_id=1)
    try:
        while True:
            kind, payload = ws.receive()
            if kind == "text" and payload == b"end":
                ws.send_json({"type": "final", "text": t.flush().committed_text})
                return
            res = t.feed(np.frombuffer(payload, np.float32))
            if res is not None:
                ws.send_json({"type": "partial", "committed": res.committed_text, "pending": res.partial_text})
    except ConnectionClosed:
        pass
'''


def boot_split(boot: dict, t_submit: float, t_first: float, kernels_s: float) -> dict:
    """A container's boot, from the supervisor's spawn to its first result:
    spawn, interpreter, ``import torch``, the app file, the kernel libraries
    loaded, snap hooks or restore (and capture), the other hooks."""
    s = boot["boot_s"]
    out = {k: s[k] for k in ("spawn", "interpreter", "handshake", "import_torch", "app_file") if k in s}
    for k in ("snap_hooks", "restore", "capture"):
        if k in s:
            out[k] = s[k]
    out["kernel_libraries"] = kernels_s
    out["other_enter_hooks"] = s.get("enter_hooks", 0.0) - kernels_s
    out["to_first_result"] = t_first - t_submit
    return out


def phase14_snapshot(load_module_from_path, path: Path, snap_dir: Path, SamplingParams) -> dict:
    """14a: three boots of a snapshot-enabled class, each in a fresh
    container: a miss that captures, a hit that runs no snap hook, a fallback
    after a corrupted payload; the same greedy rows each time."""
    import modal_examples_tpu_torch as mtpu
    from modal_examples_tpu_torch.snapshot.store import SnapshotStore

    mod = load_module_from_path(str(path))
    reqs = make_requests(SamplingParams)[:SNAP_PROMPTS]
    prompts, max_tokens = [p for p, _ in reqs], [sp.max_tokens for _, sp in reqs]
    progress = mtpu.Dict.from_name(mod.PROGRESS)
    store = SnapshotStore(root=snap_dir)
    boots = {}
    for name in ("miss", "hit", "fallback"):
        if name == "fallback":  # one byte of the payload flipped
            [entry] = store.entries()
            with open(store._state_path(entry["key"]), "r+b") as f:
                f.seek(entry["size_bytes"] // 2)
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 0xFF]))
        runs_before = progress.get("snap_hook_runs", 0)
        with mod.app.run():
            t0 = time.time()
            r = mod.Engine().generate.remote(prompts, max_tokens)
            t1 = time.time()
        boot = r["boot"]
        if boot.get("snapshot") != name or r["compiled"]:
            raise AssertionError(f"14a {name} boot: snapshot {boot.get('snapshot')}, compiled {r['compiled']}")
        ran = progress.get("snap_hook_runs", 0) - runs_before
        if ran != (0 if name == "hit" else 1) or r["snap_hook_runs"] != progress.get("snap_hook_runs", 0):
            raise AssertionError(f"14a {name} boot: the snap hook ran {ran} times in the container")
        if min(r["launches"].values()) <= 0:
            raise AssertionError(f"14a {name} boot: launches {r['launches']}")
        [entry] = store.entries()
        boots[name] = {"split_s": boot_split(boot, t0, t1, r["kernels_s"]), "launches": r["launches"],
                       "captured": boot.get("captured"), "rows": r["rows"], "entry_bytes": entry["size_bytes"],
                       "card": r["card"]}
    for name in ("hit", "fallback"):
        if boots[name]["rows"] != boots["miss"]["rows"]:
            raise AssertionError(f"14a: the {name} boot's greedy rows differ from the miss boot's")
    if not (boots["miss"]["captured"] and boots["fallback"]["captured"] and not boots["hit"]["captured"]):
        raise AssertionError(f"14a: captured {[(k, b['captured']) for k, b in boots.items()]}")
    nbytes = boots["miss"]["entry_bytes"]
    out = {"entry_bytes": nbytes, "card": boots["miss"]["card"],
           "capture_s": boots["miss"]["split_s"]["capture"], "restore_s": boots["hit"]["split_s"]["restore"],
           "split_s": {k: b["split_s"] for k, b in boots.items()},
           "launches": {k: sum(b["launches"][k] for b in boots.values()) for k in boots["miss"]["launches"]},
           "rows_equal": True}
    out["capture_gb_per_s"] = nbytes / 1e9 / out["capture_s"]
    out["restore_gb_per_s"] = nbytes / 1e9 / out["restore_s"]
    log(f"14a snapshot-restored engine ({out['card']}): entry {nbytes / 1e9:.3f} GB, capture {out['capture_s']:.2f} s "
        f"({out['capture_gb_per_s']:.2f} GB/s), restore {out['restore_s']:.2f} s ({out['restore_gb_per_s']:.2f} GB/s); "
        f"boot split miss {json.dumps(out['split_s']['miss'])}; hit {json.dumps(out['split_s']['hit'])}; "
        f"fallback {json.dumps(out['split_s']['fallback'])}")
    return out


def phase14_lora(load_module_from_path, path: Path, progress_name: str, n_layers: int, bitwise: bool) -> dict:
    """14b: the resumable fine-tune. Attempt 1 trains LORA_FAIL_AFTER steps,
    saves, commits and raises; the retry (a fresh container) resumes there
    and trains to LORA_STEPS; an uninterrupted run trains LORA_STEPS in one
    container. The retry loads what attempt 1 saved, bitwise, and its losses
    equal the uninterrupted run's (bitwise when phase 2 found the flash
    backward kernels bitwise from launch to launch, else LORA_LOSS_RTOL)."""
    import modal_examples_tpu_torch as mtpu

    mod = load_module_from_path(str(path))
    progress = mtpu.Dict.from_name(progress_name)
    with mod.app.run():
        resumed = mod.finetune.remote("resumed", LORA_STEPS, LORA_FAIL_AFTER)
        straight = mod.finetune.remote("straight", LORA_STEPS)
    first = progress["resumed/interrupted"]
    if resumed["resumed_from"] != LORA_FAIL_AFTER or resumed["loaded_digest"] != first["digest"]:
        raise AssertionError(f"14b: the retry resumed from {resumed['resumed_from']}, loaded adapters "
                             f"{'equal to' if resumed['loaded_digest'] == first['digest'] else 'unlike'} the saved ones")
    want = {str(k): v for k, v in straight["losses"].items()}
    got = {str(k): v for k, v in {**first["losses"], **resumed["losses"]}.items()}
    if set(got) != set(want):
        raise AssertionError(f"14b: steps {sorted(got)} against {sorted(want)}")
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    if (bitwise and got != want) or rel > LORA_LOSS_RTOL:
        raise AssertionError(f"14b: losses {got} against the uninterrupted run's {want} (bitwise {bitwise})")
    for label, launches, steps in (("attempt 1", first["launches"], LORA_FAIL_AFTER),
                                   ("the retry", resumed["launches"], LORA_STEPS - LORA_FAIL_AFTER),
                                   ("the uninterrupted run", straight["launches"], LORA_STEPS)):
        if launches != {k: n_layers * steps for k in launches}:
            raise AssertionError(f"14b {label}: launches {launches}, want {n_layers} x {steps} each")
    # each container's first step warms its libraries up: left out
    steps_s = first["step_s"][1:] + resumed["step_s"][1:] + straight["step_s"][1:]
    out = {"losses": got, "losses_equal": got == want, "max_rel": rel, "tolerance": "bitwise" if bitwise else LORA_LOSS_RTOL,
           "step_ms_median": 1e3 * statistics.median(steps_s), "checkpoint_bytes": first["bytes"],
           "write_and_commit_s": first["save_s"],
           "launches": {k: first["launches"][k] + resumed["launches"][k] + straight["launches"][k]
                        for k in first["launches"]}}
    log(f"14b resumable LoRA fine-tune: {json.dumps(out)}")
    return out


def phase14_asr(load_module_from_path, path: Path) -> dict:
    """14c: whisper-base streamed over the gateway's websocket: 8 s of seeded
    audio in 0.5 s float32 chunks, then "end". The final transcript equals an
    in-process ``StreamingTranscriber``'s on the card over the same chunks;
    committed text never retracts; the first partial's latency logged."""
    from modal_examples_tpu_torch.models import whisper
    from modal_examples_tpu_torch.serving.streaming_asr import StreamingTranscriber
    from modal_examples_tpu_torch.utils import audio
    from modal_examples_tpu_torch.web.gateway import Gateway
    from modal_examples_tpu_torch.web.websocket import connect

    cfg = whisper.WhisperConfig.base()
    params = whisper.init_params(cfg, seed=0, device="cuda")  # phase 9's weights
    rng = np.random.default_rng(14)
    wave = (audio.synth_tone_audio([330.0, 660.0, 990.0], seconds=ASR_AUDIO_S)
            + 0.05 * rng.standard_normal(int(ASR_AUDIO_S * audio.SAMPLE_RATE))).astype(np.float32)
    n = int(ASR_CHUNK_S * audio.SAMPLE_RATE)
    chunks = [wave[i:i + n] for i in range(0, len(wave), n)]
    local = StreamingTranscriber(params, cfg, bos_id=0, eos_id=1)
    expected = [local.feed(c) for c in chunks]
    final_local = local.flush().committed_text
    mod = load_module_from_path(str(path))
    mod.MODEL.update(params=params, cfg=cfg)
    with mod.app.run():
        gw = Gateway(mod.app).start()
        try:
            host, port = gw.httpd.server_address[:2]
            ws = connect(host, port, "/transcribe_ws", read_timeout=120)
            partials, first_latency = [], None
            for c, want in zip(chunks, expected):
                t0 = time.perf_counter()
                ws.send_bytes(c.tobytes())
                if want is not None:  # this chunk completes an update: one event is due
                    evt = json.loads(ws.receive()[1])
                    if first_latency is None:
                        first_latency = time.perf_counter() - t0
                    partials.append(evt)
            ws.send_text("end")
            final = json.loads(ws.receive()[1])
            ws.close()
        finally:
            gw.stop()
    committed = [e["committed"] for e in partials]
    if final["type"] != "final" or any(e["type"] != "partial" for e in partials) or not partials:
        raise AssertionError(f"14c: events {partials} then {final}")
    if final["text"] != final_local or committed != [r.committed_text for r in expected if r is not None]:
        raise AssertionError(f"14c: the websocket's transcript {final['text']!r} is not the in-process one "
                             f"{final_local!r}")
    if any(not b.startswith(a) for a, b in zip(committed, committed[1:] + [final["text"]])):
        raise AssertionError(f"14c: committed text retracted: {committed} then {final['text']!r}")
    out = {"partials": len(partials), "final_chars": len(final["text"]), "first_partial_s": first_latency,
           "audio_s": ASR_AUDIO_S, "chunk_s": ASR_CHUNK_S}
    log(f"14c streaming ASR over a websocket: {json.dumps(out)}")
    return out


def check_oci_layout(dest: Path) -> dict:
    """The layout's index, manifest, config and layers: every blob's digest
    and size, every layer's diff_id over its uncompressed tar."""
    import gzip
    import hashlib

    def blob(digest: str) -> bytes:
        data = (dest / "blobs" / "sha256" / digest.split(":")[1]).read_bytes()
        if "sha256:" + hashlib.sha256(data).hexdigest() != digest:
            raise AssertionError(f"14d: blob {digest} does not hash to its name")
        return data

    if json.loads((dest / "oci-layout").read_text()) != {"imageLayoutVersion": "1.0.0"}:
        raise AssertionError("14d: oci-layout")
    [mdesc] = json.loads((dest / "index.json").read_text())["manifests"]
    manifest = json.loads(blob(mdesc["digest"]))
    config = json.loads(blob(manifest["config"]["digest"]))
    for ldesc, diff_id in zip(manifest["layers"], config["rootfs"]["diff_ids"], strict=True):
        data = blob(ldesc["digest"])
        if ldesc["size"] != len(data) or "sha256:" + hashlib.sha256(gzip.decompress(data)).hexdigest() != diff_id:
            raise AssertionError(f"14d: layer {ldesc['digest']} size or diff_id")
    return {"layers": len(manifest["layers"]), "history": len(config["history"]),
            "base": config["history"][0]["created_by"]}


def phase14_cheap(tmpdir: Path) -> dict:
    """14d: a ``Sandbox`` on the card's machine (stdout, the exit code, an
    exec timeout) and ``Image.cuda_base().add_local_file(...).export_oci``."""
    import modal_examples_tpu_torch as mtpu

    sb = mtpu.Sandbox.create(timeout=120)
    try:
        p = sb.exec("nvidia-smi", "--query-gpu=name", "--format=csv,noheader")
        code, name = p.wait(), p.stdout.read().strip()
        bad = sb.exec(sys.executable, "-c", "import sys; print('out'); sys.exit(3)")
        bad_code, bad_out = bad.wait(), bad.stdout.read().strip()
        t0 = time.monotonic()
        slow = sb.exec(sys.executable, "-c", "import time; time.sleep(60)", timeout=1.0)
        slow_code, slow_s = slow.wait(), time.monotonic() - t0
    finally:
        sb.cleanup()
    if code != 0 or name != torch.cuda.get_device_name(0) or (bad_code, bad_out) != (3, "out") or slow_code >= 0 \
            or slow_s > 30:
        raise AssertionError(f"14d sandbox: nvidia-smi {code} {name!r}, exit {bad_code} {bad_out!r}, "
                             f"timeout {slow_code} after {slow_s:.1f}s")
    (tmpdir / "weights.txt").write_text("phase 14d\n")
    img = mtpu.Image.cuda_base().add_local_file(str(tmpdir / "weights.txt"), "/weights.txt")
    summary = img.export_oci(str(tmpdir / "oci"), tag="smoke")
    layout = check_oci_layout(tmpdir / "oci")
    if layout["layers"] != 1 or "cuda_base" not in layout["base"] or summary["n_layers"] != 1:
        raise AssertionError(f"14d OCI: {layout}, {summary}")
    out = {"sandbox": {"card_seen": name, "exit_code": bad_code, "timeout_code": slow_code, "timeout_s": slow_s},
           "oci": {**layout, "manifest_digest": summary["manifest_digest"]}}
    log(f"14d cheap checks: {json.dumps(out)}")
    return out


def phase_platform_rest(SamplingParams, n_layers: int, bwd_bitwise: bool) -> dict:
    """Phase 14: the platform layer's rest on the card, after phase 11, in
    the same spawned-container setup: (14a) a snapshot-restored engine,
    (14b) a resumable LoRA fine-tune, (14c) streaming ASR over a websocket,
    (14d) a sandbox and an OCI export."""
    import tempfile

    import modal_examples_tpu_torch as mtpu
    from modal_examples_tpu_torch.core.app import load_module_from_path

    out = {}
    t0 = time.monotonic()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-apps-", dir=ROOT / "build") as d:
        d = Path(d)
        snap_dir = d / "snapshots"
        old = os.environ.get("MTPU_SNAPSHOT_DIR")
        os.environ["MTPU_SNAPSHOT_DIR"] = str(snap_dir)  # resolved client-side when the pool is made
        progress = mtpu.Dict.from_name(f"smoke-14-{os.getpid()}")
        try:
            snap = write_app(d, "smoke_snapshot", APP_SNAPSHOT, DEPTH=SNAP_DEPTH, PROGRESS=progress.name)
            out["snapshot"] = phase14_snapshot(load_module_from_path, snap, snap_dir, SamplingParams)
            shutil.rmtree(snap_dir, ignore_errors=True)
            lora_app = write_app(d, "smoke_lora", APP_LORA, SETUP={
                "config": "llama2_7b", "rank": 16, "batch": (2, 512), "lr": 1e-4, "device": "cuda", "gpu": "H100",
                "mount": str(d / "ckpts"), "volume": f"smoke-lora-{os.getpid()}", "progress": progress.name})
            out["lora"] = phase14_lora(load_module_from_path, lora_app, progress.name, n_layers, bwd_bitwise)
            mtpu.Volume.delete(f"smoke-lora-{os.getpid()}")
            out["asr"] = phase14_asr(load_module_from_path, write_app(d, "smoke_asr", APP_ASR))
            out["cheap"] = phase14_cheap(d)
        finally:
            mtpu.Dict.delete(progress.name)
            if old is None:
                os.environ.pop("MTPU_SNAPSHOT_DIR", None)
            else:
                os.environ["MTPU_SNAPSHOT_DIR"] = old
    out["seconds"] = time.monotonic() - t0
    launches = dict(out["snapshot"]["launches"])
    for k, v in out["lora"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["container_launches"] = launches
    return out



# -- training ---------------------------------------------------------------------


def adapter_grads(loss_fn, adapters, batch, attn_impl):
    leaves = {k: v.detach().requires_grad_(True) for k, v in adapters["layers"].items()}
    loss = loss_fn({"layers": leaves}, batch, attn_impl=attn_impl)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def check_grads_against_xla(loss_fn, adapters, batch, targets, cosine_min: float = GRAD_COSINE_MIN) -> dict:
    """The first step's adapter gradients through the flash kernels against
    the plain xla attention (autograd through dense attention) on the card.
    b = 0 at init, so every a-gradient is exactly zero on both paths and the
    b-gradients carry the comparison."""
    flash = adapter_grads(loss_fn, adapters, batch, "flash")
    xla = adapter_grads(loss_fn, adapters, batch, "xla")
    return compare_adapter_grads(flash, xla, targets, "flash vs xla", cosine_min)


def compare_adapter_grads(flash, xla, targets, label: str, cosine_min: float = GRAD_COSINE_MIN) -> dict:
    """Per target: the b-gradients' cosine (held at ``cosine_min``) and max
    relative error; every a-gradient must be exactly zero (b = 0)."""
    out = {}
    for t in targets:
        if flash[f"{t}_a"].abs().max() != 0 or xla[f"{t}_a"].abs().max() != 0:
            raise AssertionError(f"{t}_a gradient is not zero with b = 0")
        f, x = flash[f"{t}_b"].float().flatten(), xla[f"{t}_b"].float().flatten()
        cos = torch.nn.functional.cosine_similarity(f, x, dim=0).item()
        rel = max_err(f, x) / x.abs().max().item()
        out[t] = {"cosine": cos, "max_rel_err": rel}
        log(f"  {t}_b grad {label}: cosine {cos:.6f}, max rel err {rel:.3g}, max|g| {x.abs().max().item():.3g}")
    worst = min(v["cosine"] for v in out.values())
    if not worst >= cosine_min:
        raise AssertionError(f"adapter gradients disagree ({label}): cosine {worst} < {cosine_min}")
    return out


def lora_training_setup(llama, lora, training, params, steps: int):
    """The training path: Llama-2-7B over the frozen ``params``, rank-16
    LoRA (alpha 16, scale 1.0) on all seven projections, ``steps`` batches
    of B=2 x S=512 random tokens (mask of ones), the masked next-token loss
    through ``llama.forward``. Returns (cfg, lcfg, adapters, batches, loss_fn)."""
    cfg = llama.LlamaConfig.llama2_7b()
    lcfg = lora.LoRAConfig(rank=16)
    B, S = 2, 512
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), params, lcfg)
    for p in params["layers"]:  # bf16 tensors, or int8 QuantizedWeights (no requires_grad)
        if any(getattr(t, "requires_grad", False) for t in p.values()):
            raise AssertionError("the base must be frozen")
    tok_gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [
        {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=tok_gen, device="cuda"),
         "mask": torch.ones((B, S), device="cuda")}
        for _ in range(steps)
    ]

    def loss_fn(ad, batch, attn_impl="flash"):
        logits = llama.forward(params, batch["tokens"], cfg, attn_impl=attn_impl, lora=ad, lora_scale=lcfg.scale)
        return training.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    return cfg, lcfg, adapters, batches, loss_fn


def phase_training(fa, llama, lora, training, params) -> dict:
    steps = 5
    cfg, lcfg, adapters, batches, loss_fn = lora_training_setup(llama, lora, training, params, steps)
    B, S = batches[0]["tokens"].shape
    log(f"training: llama2-7b frozen bf16 base, LoRA rank {lcfg.rank} scale {lcfg.scale} on {lcfg.targets}, "
        f"{lora.param_count(adapters) / 1e6:.2f}M adapter params, B={B} S={S}")
    grads = check_grads_against_xla(loss_fn, adapters, batches[0], lcfg.targets)
    gc.collect()
    torch.cuda.empty_cache()

    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    step_s, losses, norms = [], [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    counts = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"training steps: loss {losses}, grad_norm {norms}, step s {step_s}, launches {counts}")
    want = cfg.n_layers * steps
    if counts != {k: want for k in counts}:
        raise AssertionError(f"training launches {counts}: want {want} each ({cfg.n_layers} layers x {steps} steps)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
    moved = {t: state.params["layers"][f"{t}_b"].abs().max().item() for t in lcfg.targets}
    if min(moved.values()) <= 0:
        raise AssertionError(f"b adapters did not move off zero: {moved}")
    if state.step != steps:
        raise AssertionError(f"state.step {state.step} != {steps}")
    if not peak < total:
        raise AssertionError(f"peak memory {peak} not under the card's {total}")
    step_med = statistics.median(step_s[1:])
    metrics = {
        "train_tok_per_s": B * S / step_med,
        "step_ms_median": 1e3 * step_med,
        "step_ms": [1e3 * x for x in step_s],
        "peak_gb": peak / 1e9,
        "card_gb": total / 1e9,
        "losses": losses,
        "launches": counts,
        "grad_check": grads,
    }
    log(f"training metrics: train {metrics['train_tok_per_s']:.1f} tok/s, step {metrics['step_ms_median']:.1f} ms "
        f"(median of {steps - 1} after 1 warm-up), peak {metrics['peak_gb']:.2f} GB of {metrics['card_gb']:.2f} GB; "
        f"{json.dumps(metrics)}")
    return metrics


# -- phase 12 ---------------------------------------------------------------------


class plain_int8_products:
    """K7's plain version (``qmm_plain``) in place of the kernel's wrapper for
    the products of a ``with`` block: the comparison path of phase 12. The
    plain version counts no launch."""

    def __init__(self, qmm):
        self.qmm, self.kernel = qmm, qmm.qmm_cuda

    def __enter__(self):
        self.qmm.qmm_cuda = self.qmm.qmm_plain

    def __exit__(self, *exc):
        self.qmm.qmm_cuda = self.kernel


def phase_int8_lora(fa, qmm, llama, lora, training, quantize, bf16_peak_gb: float) -> dict:
    """``bench.py``'s int8 LoRA step at full Llama-2-7B width and depth:
    ``init_quantized_llama`` (random int8 weights drawn on the card), rank
    16 on all seven projections (f32 adapters, as the reference's), B=2 x
    S=512, the masked next-token loss. The first step's adapter gradients
    through K7 and the flash kernels against the same step through K7's and
    attention's plain versions; then, counters zeroed, 1 warm-up and 3 timed
    ``Trainer`` steps: K7 7 x n_layers + 1 times a step (the forward; the
    backward's ``dX = (dY * scale) @ q^T`` is a bf16 product), K1, K5 and K6
    n_layers times a step; the peak memory below the bf16 base's."""
    steps = 4
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    qparams = quantize.init_quantized_llama(cfg, seed=0, bits=8, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    _, lcfg, adapters, batches, loss_fn = lora_training_setup(llama, lora, training, qparams, steps)
    if any(v.dtype != torch.float32 for v in adapters["layers"].values()):
        raise AssertionError("adapters over an int8 base must be f32")
    B, S = batches[0]["tokens"].shape
    log(f"phase 12 int8 LoRA: llama2-7b int8 base ({quantize.param_bytes(qparams) / 1e9:.2f} GB, drawn in "
        f"{init_s:.1f}s), LoRA rank {lcfg.rank} f32 on {lcfg.targets}, B={B} S={S}")
    t0 = time.monotonic()
    kernels = adapter_grads(loss_fn, adapters, batches[0], "flash")
    with plain_int8_products(qmm):
        plain = adapter_grads(loss_fn, adapters, batches[0], "xla")
    grads = compare_adapter_grads(kernels, plain, lcfg.targets, "K7 + flash vs plain int8 products + xla")
    grad_s = time.monotonic() - t0
    del kernels, plain
    gc.collect()
    torch.cuda.empty_cache()

    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    qmm.qmm_launches = 0
    step_s, losses, k7_steps = [], [], []
    for batch in batches:
        k7_before = qmm.qmm_launches
        t1 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        losses.append(m["loss"].item())
        k7_steps.append(qmm.qmm_launches - k7_before)
    counts = {"quantized_matmul": qmm.qmm_launches, "flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
              "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    k7_want = len(lcfg.targets) * cfg.n_layers + isinstance(qparams.get("lm_head"), quantize.QuantizedWeight)
    log(f"phase 12 steps: loss {losses}, step s {step_s}, K7 a step {k7_steps}, launches {counts}")
    if k7_steps != [k7_want] * steps:
        raise AssertionError(f"K7 launches a step {k7_steps}: want {k7_want}")
    flash_want = cfg.n_layers * steps
    if [counts[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] != [flash_want] * 3:
        raise AssertionError(f"flash launches {counts}: want {flash_want} each")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite int8 LoRA loss: {losses}")
    moved = {t: state.params["layers"][f"{t}_b"].abs().max().item() for t in lcfg.targets}
    if min(moved.values()) <= 0:
        raise AssertionError(f"b adapters did not move off zero: {moved}")
    if not peak < bf16_peak_gb:
        raise AssertionError(f"int8 LoRA peak {peak:.2f} GB is not below the bf16 base's {bf16_peak_gb:.2f} GB")
    step_med = statistics.median(step_s[1:])
    out = {
        "train_tok_per_s": B * S / step_med,
        "step_ms_median": 1e3 * step_med,
        "step_ms": [1e3 * x for x in step_s],
        "losses": losses,
        "k7_per_step": k7_want,
        "peak_gb": peak,
        "bf16_peak_gb": bf16_peak_gb,
        "base_gb": quantize.param_bytes(qparams) / 1e9,
        "grad_check_s": grad_s,
        "launches": counts,
        "grad_check": grads,
    }
    log(f"phase 12 metrics: {out['train_tok_per_s']:.1f} tok/s, step {out['step_ms_median']:.1f} ms (median of "
        f"{steps - 1} after 1 warm-up), K7 {k7_want} a step, peak {peak:.2f} GB against the bf16 base's "
        f"{bf16_peak_gb:.2f} GB; {json.dumps(out)}")
    return out


# -- phase 13 ---------------------------------------------------------------------


def http_json(url: str) -> tuple:
    """(status, JSON body) of one GET, error statuses included."""
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_observability(fa, pa, llama, LLMEngine, params) -> dict:
    """The operations layer over Llama-2-7B on the card (phase 3's resident
    bf16 weights and ``SERVE_KW``): a gateway answers ``/healthz``,
    ``/alerts`` and ``/incidents`` over HTTP; the canary records a golden
    (three greedy probes), a second round passes bit-exact, and a third with
    ``engine.canary_token_corrupt`` armed reports drift on the first probe's
    first token and captures a ``canary_drift`` incident bundle naming the
    probe request, listed by ``/incidents`` after. The counters are zeroed
    just before the rounds and read just after: K1, K2 and K3 launched."""
    from modal_examples_tpu_torch import App, SamplingParams
    from modal_examples_tpu_torch.faults import inject
    from modal_examples_tpu_torch.observability import canary, incident, reqtrace
    from modal_examples_tpu_torch.web.gateway import Gateway

    t0 = time.monotonic()
    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, params, **SERVE_KW)
    eng.trace_name = "smoke-7b"
    golden_dir = ROOT / "build" / f"canary-{os.getpid()}"
    gw = Gateway(App("smoke-observability")).start()
    out: dict = {}
    try:
        routes = {}
        for path in ("/healthz", "/alerts", "/incidents"):
            code, body = http_json(gw.base_url + path)
            routes[path] = code
            if path == "/healthz":
                if code not in (200, 503) or body["status"] not in ("ok", "degraded") or not body["slos"]:
                    raise AssertionError(f"/healthz answered {code}: {body}")
                out["healthz"] = {"status": body["status"], "slos": {r["name"]: r["ok"] for r in body["slos"]}}
            elif code != 200:
                raise AssertionError(f"{path} answered {code}: {body}")
            elif path == "/alerts":
                out["alert_rules"] = [r["rule"] for r in body["rules"]]
        out["routes"] = routes
        fp = canary.fingerprint(eng)
        if (fp["backend"], fp["device"], fp["kernel_impl"]) != ("cuda", torch.cuda.get_device_name(0), "cuda"):
            raise AssertionError(f"the canary's identity does not name this card: {fp}")
        prober = canary.CanaryProber(eng, interval_s=3600.0, store=canary.GoldenStore(root=golden_dir))
        eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
        fa.launches = pa.decode_launches = pa.scatter_launches = 0
        rounds = [prober.probe_once()["smoke-7b"], prober.probe_once()["smoke-7b"]]
        plan = inject.FaultPlan({"engine.canary_token_corrupt": {"on_hit": 1}}, seed=0)
        with inject.active(plan):
            rounds.append(prober.probe_once()["smoke-7b"])
        counts = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
        verdicts = [[r["result"] for r in rnd] for rnd in rounds]
        log(f"phase 13 canary rounds {verdicts}, launches {counts}, fingerprint {fp}")
        if min(counts.values()) <= 0:
            raise AssertionError(f"a kernel of the canary's path never launched: {counts}")
        if verdicts != [["recorded"] * 3, ["pass"] * 3, ["drift", "pass", "pass"]]:
            raise AssertionError(f"canary verdicts {verdicts}: want recorded, pass, drift on g0")
        drift = rounds[2][0]
        if drift["mismatch_at"] != 0 or drift["tokens"][0] != (drift["expected"][0] + 1) % cfg.vocab_size:
            raise AssertionError(f"the drift is not the planted flip: {drift}")
        if [r["tokens"] for r in rounds[1]] != [r["tokens"] for r in rounds[0]]:
            raise AssertionError("the second round's tokens are not the golden's")
        bundles = [m for m in incident.list_incidents()
                   if m["trigger"] == "canary_drift" and drift["request_id"] in m.get("reason", "")]
        if len(bundles) != 1:
            raise AssertionError(f"want one canary_drift bundle naming {drift['request_id']}: {bundles}")
        code, listed = http_json(gw.base_url + "/incidents")
        code2, manifest = http_json(f"{gw.base_url}/incidents/{bundles[0]['id']}")
        if code != 200 or bundles[0]["id"] not in [m["id"] for m in listed["incidents"]] or code2 != 200:
            raise AssertionError(f"/incidents does not list the drift bundle: {code} {code2}")
        code, cn = http_json(gw.base_url + "/canary")
        if code != 200 or not cn["journal"]:
            raise AssertionError(f"/canary answered {code}: {cn}")
        probes = [r for rnd in rounds for r in rnd]
        # random weights decode to few printable bytes, so a probe may stream
        # no text piece before its end (no client-side TTFT): the engine's
        # clock on the probe's trace root (``ttft_s``) times every probe
        engine_ttft = [next(sp["attrs"]["ttft_s"] for sp in reqtrace.read_trace(r["request_id"])
                            if sp["name"] == "request") for r in probes]
        out.update({
            "verdicts": verdicts,
            "launches": counts,
            "fingerprint": fp,
            "incident": {"id": bundles[0]["id"], "reason": bundles[0]["reason"], "files": sorted(bundles[0]["files"])},
            "probe_ttft_s": engine_ttft,
            "probe_ttft_client_s": [r["ttft"] for r in probes],
            "probe_e2e_s": [r["e2e"] for r in probes],
            "probe_ttft_s_median": statistics.median(engine_ttft),
            "probe_e2e_s_median": statistics.median(r["e2e"] for r in probes),
            "seconds": time.monotonic() - t0,
        })
    finally:
        gw.stop()
        eng.stop()
        shutil.rmtree(golden_dir, ignore_errors=True)
    log(f"phase 13 observability: ok in {out['seconds']:.1f}s; probe TTFT median {out['probe_ttft_s_median']:.3f}s, "
        f"e2e median {out['probe_e2e_s_median']:.3f}s; {json.dumps(out)}")
    return out


# -- phase 6 ----------------------------------------------------------------------

#: phase 6b's shared system prompt: 320 tokens, 20 full pages of 16
SYSTEM_TOKENS = 320


def page_rows(pages, ids: list) -> list:
    """The rows of ``ids`` in every layer: the bf16 pages, or an int8 cache's
    data and scales."""
    from modal_examples_tpu_torch.ops.kv_quant import is_quantized

    idx = torch.tensor(ids, device=pages.device)
    if is_quantized(pages):
        return [pages.data[:, idx], pages.scale[:, idx]]
    return [pages[:, idx]]


def shared_page_rewrite(llama, params, cfg, kv_dtype: str) -> dict:
    """Whether one prefix's K/V pages come out bitwise equal from each
    prefill shape that writes a shared page: its first 8 pages alone at
    bucket 128 (row 0 of 4), the whole 20-page prefix with a suffix at bucket
    512 in row 0 and in row 3 (other prompts in the other rows), and as the
    first 512-token chunk of a 1500-token prompt (``prefill_chunk``). Returns
    the largest difference of each pair (0.0 means bitwise equal)."""
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    gen = torch.Generator(device="cuda").manual_seed(61)
    prefix = torch.randint(0, 256, (SYSTEM_TOKENS,), generator=gen, device="cuda", dtype=torch.int32)
    cache = PagedKVCache.create(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                n_pages=1 + 4 * 32 * 3 + 32, page_size=16, kv_dtype=kv_dtype, device="cuda")
    next_page = itertools.count(1)

    def table(n: int):
        return torch.tensor([next(next_page) for _ in range(n)], device="cuda", dtype=torch.int32)

    def batch(bucket: int, row: int, n_prompt: int):
        """A [4, bucket] prefill with the prefix leading row ``row``; returns its pages."""
        toks = torch.randint(0, 256, (4, bucket), generator=gen, device="cuda", dtype=torch.int32)
        toks[row, : min(bucket, SYSTEM_TOKENS)] = prefix[:bucket]
        lens = torch.tensor([bucket - 7 * i for i in range(4)], device="cuda", dtype=torch.int32)
        lens[row] = n_prompt
        tables = torch.stack([table(bucket // 16) for _ in range(4)])
        llama.prefill(params, toks, cache.k_pages, cache.v_pages, tables, lens, cfg)
        return tables[row].tolist()

    a = batch(128, 0, 128)
    b = batch(512, 0, 400)
    c = batch(512, 3, 450)
    long = torch.randint(0, 256, (1, 512), generator=gen, device="cuda", dtype=torch.int32)
    long[0, :SYSTEM_TOKENS] = prefix
    d = table(32)
    llama.prefill_chunk(params, long, cache.k_pages, cache.v_pages, d[None], torch.tensor([512], device="cuda"), cfg,
                        q_offset=0)
    d = d.tolist()
    torch.cuda.synchronize()

    def diff(x: list, y: list, n: int) -> float:
        return max(
            max_err(rx, ry)
            for pages in (cache.k_pages, cache.v_pages)
            for rx, ry in zip(page_rows(pages, x[:n]), page_rows(pages, y[:n]))
        )

    n = SYSTEM_TOKENS // 16
    out = {
        "bucket 128 vs 512 (8 pages)": diff(a, b, 8),
        "row 0 vs row 3 at 512 (20 pages)": diff(b, c, n),
        "chunk vs bucket 512 (20 pages)": diff(d, b, n),
    }
    del cache
    return out


SERVE_KW = dict(max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8,
                seed=0, device="cuda")
#: HF llama names of a layer's tensors, stored [out, in] (norms as they are)
HF_LAYER = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
            "attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}
CHECKPOINT_LAYERS = 2


def write_checkpoint(params, cfg, path: Path) -> int:
    """The first ``CHECKPOINT_LAYERS`` layers of ``params`` (with the
    embeddings, final norm and head) as an HF llama checkpoint in two shards,
    with its ``config.json``, through the port's writer. Returns its bytes."""
    from modal_examples_tpu_torch.utils.safetensors import save_file

    def hf(t, name):  # [in, out] -> HF [out, in]
        return t.T.contiguous() if t.ndim == 2 and "norm" not in name else t

    shards = [{"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]},
              {"lm_head.weight": hf(params["lm_head"], "lm_head")}]
    for li in range(CHECKPOINT_LAYERS):
        for name, key in HF_LAYER.items():
            shards[li % 2][f"model.layers.{li}.{key}.weight"] = hf(params["layers"][li][name], name)
    for i, shard in enumerate(shards):
        save_file(shard, path / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors", metadata={"format": "pt"})
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim, "num_hidden_layers": CHECKPOINT_LAYERS, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.ffn_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps, "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    }))
    return sum(f.stat().st_size for f in path.glob("*.safetensors"))


def check_loaded(eng, params, quantize_weight_host) -> None:
    """The engine's weights bitwise equal to the written ones (int8: to
    ``quantize_weight_host`` of the written ones, q and scale)."""
    from modal_examples_tpu_torch.models.quantize import QuantizedWeight

    def same(got, want, name):
        if isinstance(got, QuantizedWeight):
            ref = quantize_weight_host(want.cpu(), device="cpu")
            ok = torch.equal(got.q.cpu(), ref.q) and torch.equal(got.scale.cpu(), ref.scale)
        else:
            ok = got.dtype == want.dtype and torch.equal(got, want)
        if not ok:
            raise AssertionError(f"loaded {name} differs from the written checkpoint")

    for name in ("embed", "final_norm", "lm_head"):
        same(eng.params[name], params[name], name)
    for li in range(CHECKPOINT_LAYERS):
        for name in HF_LAYER:
            same(eng.params["layers"][li][name], params["layers"][li][name], f"layers[{li}].{name}")


def phase_checkpoint(fa, pa, llama, layers, reference, SamplingParams, params, card: str) -> dict:
    """6a: a Llama-2-7B-width checkpoint at depth 2 written with the port's
    writer, loaded through ``build_engine(model_dir=...)`` in bf16 and with
    int8 weights and pages; each tree held bitwise, each engine serving the
    burst and passing the dense check, the int8 one launching K7, K2-int8 and
    K3-int8."""
    import dataclasses
    import tempfile

    from modal_examples_tpu_torch.models.quantize import quantize_weight_host
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm
    from modal_examples_tpu_torch.serving.engine import build_engine

    cfg = llama.LlamaConfig.llama2_7b()
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="checkpoint-", dir=ROOT / "build") as d:
        t0 = time.monotonic()
        nbytes = write_checkpoint(params, cfg, Path(d))
        out["write_s"] = time.monotonic() - t0
        out["checkpoint_gb"] = nbytes / 1e9
        for label, kw in (("bf16", {}), ("int8", dict(quantization="int8", kv_dtype="int8"))):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            eng = build_engine(model_dir=d, **SERVE_KW, **kw)
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            if eng.cfg != dataclasses.replace(cfg, n_layers=CHECKPOINT_LAYERS):
                raise AssertionError(f"config.json read as {eng.cfg}")
            if type(eng.tokenizer).__name__ != "ByteTokenizer":  # the directory holds no tokenizer files
                raise AssertionError(f"6a: tokenizer {type(eng.tokenizer).__name__}, want the byte tokenizer")
            check_loaded(eng, params, quantize_weight_host)
            log(f"6a checkpoint {label}: build_engine(model_dir=...) {load_s:.2f}s for {nbytes / 1e9:.3f} GB of "
                f"safetensors ({nbytes / 1e9 / load_s:.2f} GB/s from the page cache, engine set-up included), "
                f"tree bitwise equal to the written arrays{' (int8: quantize_weight_host)' if kw else ''}; "
                f"tokenizer {type(eng.tokenizer).__name__}; card {card}")
            eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
            fa.launches = qmm.qmm_launches = pa.decode_launches = pa.scatter_launches = 0
            pa.decode_int8_launches = pa.scatter_int8_launches = 0
            _, m = serve_burst(eng, SamplingParams, f"6a checkpoint engine {label}")
            counts = {"flash_fwd": fa.launches, "quantized_matmul": qmm.qmm_launches,
                      "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches,
                      "paged_decode_int8": pa.decode_int8_launches, "kv_scatter_int8": pa.scatter_int8_launches}
            want = ("quantized_matmul", "paged_decode_int8", "kv_scatter_int8") if kw else ("paged_decode", "kv_scatter")
            if min(counts[k] for k in want + ("flash_fwd",)) < 1:
                raise AssertionError(f"6a {label}: a kernel of the path never launched: {counts}")
            m.update(launches=counts, load_s=load_s, load_gb_per_s=nbytes / 1e9 / load_s,
                     dense_check=check_against_dense(eng, llama, layers, reference)[0])
            eng.stop()
            del eng
            out[label] = m
    return out


def shared_prefix_requests(SamplingParams, n: int = 8):
    """``n`` requests sharing one 320-token system prompt (20 pages), each
    with its own 40..180-token question; greedy, seeded and engine-seeded rows."""
    rng = np.random.default_rng(66)
    system = "".join(chr(c) for c in rng.integers(32, 127, SYSTEM_TOKENS - 1))  # + BOS = 320 tokens
    out = []
    for i in range(n):
        question = "".join(chr(c) for c in rng.integers(32, 127, 40 + 20 * i))
        params = SamplingParams(max_tokens=24 + 4 * i, temperature=0.0 if i % 2 == 0 else 0.8,
                                seed=None if i % 4 == 3 else 600 + i)
        out.append((system + question, params))
    return out


def phase_prefix_cache(llama, LLMEngine, SamplingParams, params) -> dict:
    """6b: the shared-prefix burst with the prefix cache on (twice) and off:
    tokens identical, ``cached_tokens`` the reference's page arithmetic, every
    private page back and the cached pages exactly the trie's distinct full
    pages; then the shared-page rewrite held bitwise (bf16 and int8 pages)."""
    cfg = llama.LlamaConfig.llama2_7b()
    runs = {}
    for label, cache_on in (("on", True), ("off", False)):
        eng = LLMEngine(cfg, params, enable_prefix_cache=cache_on, **SERVE_KW)
        eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
        for rnd in range(2 if cache_on else 1):
            reqs = [eng.make_request(p, sp) for p, sp in shared_prefix_requests(SamplingParams)]
            t0 = time.monotonic()
            for r in reqs:
                eng.submit_request(r)
            for r in reqs:
                "".join(eng.stream(r))
                check_finish(r)
            wall = time.monotonic() - t0
            check_pages_returned(eng, f"6b cache {label}")
            runs[(label, rnd)] = reqs
            pc = eng.prefix_cache
            log(f"6b cache {label}, round {rnd}: {wall:.2f}s, cached_tokens {[r.cached_prompt_tokens for r in reqs]}, "
                f"{pc.stats() if pc else 'no trie'}, free pages {eng.cache.allocator.available}")
        if cache_on:
            full = {tuple(r.prompt_tokens[: (len(r.prompt_tokens) // 16) * 16][: 16 * (k + 1)])
                    for r in runs[("on", 0)] for k in range(len(r.prompt_tokens) // 16)}
            if eng.prefix_cache.cached_pages != len(full):
                raise AssertionError(f"6b: {eng.prefix_cache.cached_pages} cached pages, {len(full)} distinct full "
                                     "prompt pages")
            first = [r.cached_prompt_tokens for r in runs[("on", 0)]]
            again = [r.cached_prompt_tokens for r in runs[("on", 1)]]
            if first != [0] + [SYSTEM_TOKENS] * 7 or again != [len(r.prompt_tokens) // 16 * 16 for r in runs[("on", 1)]]:
                raise AssertionError(f"6b: cached_tokens {first} then {again}")
            trie = eng.prefix_cache.cached_pages
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    held = 0
    for key in (("on", 0), ("on", 1)):
        held += check_same_tokens(runs[key], runs[("off", 0)], f"6b cache on (round {key[1]}) against off")
    rewrite = {kv: shared_page_rewrite(llama, params, cfg, kv) for kv in ("bfloat16", "int8")}
    log(f"6b shared-page rewrite, largest difference per pair: {rewrite}")
    if any(v for r in rewrite.values() for v in r.values()):
        raise AssertionError("6b: a shared prefix page is not rewritten bitwise")
    return {"cached_tokens": [r.cached_prompt_tokens for r in runs[("on", 0)]], "trie_pages": trie,
            "rows_held": held, "rewrite_max_diff": rewrite}


def phase_budget(fa, llama, LLMEngine, SamplingParams, params) -> dict:
    """6c: a 1500-token prompt arrives while 7 streams decode, with
    ``max_prefill_tokens_per_tick=512``, the engine stepped by hand: its
    prefill spans 3 ticks (2 suspensions) with a decode block in each, and
    every token equals the unbudgeted run's on the same engine."""
    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, params, **{**SERVE_KW, "max_model_len": 2048}, max_prefill_tokens_per_tick=512)
    rng = np.random.default_rng(77)
    streams = [("".join(chr(c) for c in rng.integers(32, 127, 30 + 10 * i)),
                SamplingParams(max_tokens=60, temperature=0.0 if i % 2 else 0.7, seed=700 + i)) for i in range(7)]
    long = ("".join(chr(c) for c in rng.integers(32, 127, 1499)), SamplingParams(max_tokens=16, temperature=0.0))
    runs = {}
    for budget in (512, 0):
        eng.prefill_budget = budget
        reqs = [eng.submit(p, sp) for p, sp in streams]
        for _ in range(2):
            eng.step()
        if not all(s.decodable for s in eng.slots if s.request in reqs) or len(
                [s for s in eng.slots if s.request in reqs]) != 7:
            raise AssertionError("6c: the 7 streams are not all decoding")
        lr = eng.submit(*long)
        susp0 = eng.stats.prefill_suspensions
        ticks = []
        while lr.first_token_at is None:
            steps0, k1 = eng.stats.steps, fa.launches
            torch.cuda.synchronize()
            t0 = time.monotonic()
            eng.step()
            torch.cuda.synchronize()
            slot = next(s for s in eng.slots if s.request is lr)
            ticks.append({"wall_ms": (time.monotonic() - t0) * 1e3, "decode_steps": eng.stats.steps - steps0,
                          "flash_fwd": fa.launches - k1, "offset": slot.prefill.offset if slot.prefill else None})
        while any(not s.free for s in eng.slots):
            eng.step()
        for r in reqs + [lr]:
            drain(r)
            check_finish(r)
        runs[budget] = (reqs + [lr], ticks, eng.stats.prefill_suspensions - susp0)
        log(f"6c budget {budget}: the long prompt's prefill ticks {ticks}, suspensions {runs[budget][2]}")
    reqs, ticks, susp = runs[512]
    if len(ticks) < 3 or susp != len(ticks) - 1 or not all(t["decode_steps"] > 0 for t in ticks):
        raise AssertionError(f"6c: budgeted prefill ticks {ticks}, suspensions {susp}")
    if len(runs[0][1]) != 1:
        raise AssertionError(f"6c: the unbudgeted prefill took {len(runs[0][1])} ticks")
    held = check_same_tokens(reqs, runs[0][0], "6c budget 512 against unbudgeted")
    eng.stop()
    return {"ticks": ticks, "suspensions": susp, "unbudgeted_tick": runs[0][1][0], "rows_held": held}


def drain(req) -> str:
    """A hand-stepped request's text, its finish marker already queued (the
    scheduler thread is never started, so nothing else steps the engine)."""
    text = []
    while True:
        item = req.out_queue.get_nowait()
        if not isinstance(item, str):
            req.finish_reason = item.reason
            return "".join(text)
        text.append(item)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def phase_policy(llama, LLMEngine, SamplingParams, params) -> dict:
    """6d, two slots, a fake clock, stepped by hand: a deadline that passes
    mid-decode finishes with "deadline" and returns the pages; a queued
    request whose deadline passes is cancelled before it takes a slot; an
    interactive request is admitted before earlier default ones."""
    cfg = llama.LlamaConfig.llama2_7b()
    clock = FakeClock()
    eng = LLMEngine(cfg, params, **{**SERVE_KW, "max_slots": 2}, clock=clock)
    p = SamplingParams(max_tokens=200, temperature=0.0)
    out = {}
    doomed = eng.submit("a request that decodes past its deadline", SamplingParams(max_tokens=200, deadline_s=5.0))
    eng.step()
    n0 = doomed.n_generated
    clock.t = 10.0
    eng.step()
    drain(doomed)
    if doomed.finish_reason != "deadline" or not (0 < n0 <= doomed.n_generated < 200) or any(
            not s.free for s in eng.slots):
        raise AssertionError(f"6d in-flight deadline: {doomed.finish_reason}, {doomed.n_generated} tokens")
    check_pages_returned(eng, "6d in-flight deadline")
    out["inflight"] = {"finish": doomed.finish_reason, "generated": doomed.n_generated}
    hogs = [eng.submit(f"hog {i}", p) for i in range(2)]
    eng.step()
    queued = eng.submit("queued", SamplingParams(max_tokens=4, deadline_s=1.0))
    eng.step()
    reserved = eng.admission.reserved_pages
    clock.t += 2.0
    eng.step()
    drain(queued)
    if queued.finish_reason != "deadline" or queued.n_generated or eng.admission.reserved_pages or not reserved:
        raise AssertionError(f"6d queued deadline: {queued.finish_reason}, {queued.n_generated} tokens, "
                             f"reserved {reserved} then {eng.admission.reserved_pages}")
    out["queued"] = {"finish": queued.finish_reason, "reserved_before": reserved}
    defaults = [eng.submit(f"default {i}", SamplingParams(max_tokens=4)) for i in range(3)]
    chat = eng.submit("interactive", SamplingParams(max_tokens=4), priority="interactive")
    for r in hogs:
        eng.abort(r)
    eng.step()  # the hogs are reaped
    eng.step()  # two slots free for four queued requests
    admitted = [r for r in defaults + [chat] if r.first_token_at is not None]
    if chat not in admitted or len(admitted) != 2 or admitted[0] is not defaults[0]:
        raise AssertionError(f"6d class order: admitted {[r.prompt for r in admitted]}")
    while any(not s.free for s in eng.slots) or eng.policy.total_depth():
        eng.step()
    for r in hogs + defaults + [chat]:
        drain(r)
    check_pages_returned(eng, "6d")
    out["admitted_first"] = [r.prompt for r in admitted]
    log(f"6d policy and deadlines: {out}")
    eng.stop()
    return out


def phase_engine_surface(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params, card) -> dict:
    out = {"checkpoint": phase_checkpoint(fa, pa, llama, layers, reference, SamplingParams, params, card)}
    log("phase 6a checkpoint: ok")
    out["prefix_cache"] = phase_prefix_cache(llama, LLMEngine, SamplingParams, params)
    log("phase 6b prefix cache: ok")
    gc.collect()
    torch.cuda.empty_cache()
    out["budget"] = phase_budget(fa, llama, LLMEngine, SamplingParams, params)
    log("phase 6c prefill budget: ok")
    gc.collect()
    torch.cuda.empty_cache()
    out["policy"] = phase_policy(llama, LLMEngine, SamplingParams, params)
    log("phase 6d policy and deadlines: ok")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 5 ----------------------------------------------------------------------


def phase_numbers(fa, pa, counts: dict, errs: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    # K1 at the engine's prefill batch: 4 prompts in the 512 bucket
    B, H, S, D = 4, 32, 512, 128
    q, k, v = flash_case(gen, B, H, H, S, S)
    flops = 4 * B * H * S * S * D * 0.5
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4
    rows.append(dict(
        name="flash_fwd", source="modal_examples_tpu_torch/csrc/flash_fwd.cu",
        replaces="modal_examples_tpu/ops/flash_attention.py:40",
        ms=time_ms(lambda: fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)),
        ms_b2b=back_to_back_ms(lambda: fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)),
        plain_ms=time_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
        bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
        library_ms=time_ms(lambda: sdpa(q, k, v, True)),
        library_ms_b2b=back_to_back_ms(lambda: sdpa(q, k, v, True)),
    ))
    del q, k, v
    # K2 at a decode step of the engine's shape: 8 slots, ragged prefixes
    # 0..1000, cycled over four layers of one cache
    c = decode_case(gen, 8, 32, 32, L=32)
    per_layer = [decode_args(c, li) for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_cuda(*a, sm_scale=D**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum())  # the kernel reads each prefix's rows, not whole pages
    nbytes = 2 * rows_read * 32 * 128 * 2 + 4 * 8 * 32 * 128 * 2  # K+V rows; q, o, k_new, v_new
    rows.append(dict(
        name="paged_decode", source="modal_examples_tpu_torch/csrc/paged_decode.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:284",
        shape=f"B=8 Hq=Hkv=32 D=128 prefixes 0..1000 ({rows_read} rows), layers {CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_plain(*per_layer[0], sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    # K4 at the same shape over the same layers' pages: contexts count the
    # current token (its K/V already in the cache), so each is K2's prefix
    # plus one
    per_layer = [[c["q"], c["k_pages"][li], c["v_pages"][li], c["page_tables"], c["prefix_lens"] + 1]
                 for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_writeback_cuda(*a, sm_scale=D**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum()) + 8  # the kernel reads each context's rows, not whole pages
    nbytes = 2 * rows_read * 32 * 128 * 2 + 2 * 8 * 32 * 128 * 2  # K+V rows; q, o
    rows.append(dict(
        name="paged_decode_writeback", source="modal_examples_tpu_torch/csrc/paged_decode_writeback.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:72",
        shape=f"B=8 Hq=Hkv=32 D=128 one layer's pages, contexts 1..1001 ({rows_read} rows), layers "
              f"{CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_writeback_plain(*per_layer[0], sm_scale=D**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    # the same kernel with the folded write: its own row, the sequence it
    # replaces (K3 over the one-layer view, then K4) beside it
    f = folded_timing(pa, gen, per_layer, nbytes)
    rows.append(dict(
        name="paged_decode_writeback_folded", source="modal_examples_tpu_torch/csrc/paged_decode_writeback.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:72 with the one-layer write of :927",
        shape=rows[-1]["shape"] + ", each launch writing its 8 new rows", **f,
        library_ms=None, library_ms_b2b=None, library_op="none: no PyTorch call attends over a paged cache",
    ))
    del c, per_layer, kernel
    rows.append(scatter_row(pa, gen, int8=False))
    # K5/K6 at the training path's shape: B=2, Hq=Hkv=32, S=512, D=128, causal
    B, H, S, D = 2, 32, 512, 128
    args, _ = bwd_case(fa, gen, B, H, H, S, True, False)
    q, k, v, do = args[:4]
    one_product = 2 * 0.5 * S * S * D * B * H  # FLOPs of one causal S x S x D product, all heads
    tensor_bytes, row_bytes = B * H * S * D * 2, B * H * S * 4
    out, lse_l, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True, False, scale=D**-0.5)

    def library():  # PyTorch's flash-attention backward: dQ, dK and dV in one call
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset, scale=D**-0.5)

    library_ms, library_ms_b2b = time_ms(library), back_to_back_ms(library)
    for name, fn, plain, n_products, n_tensors, line in (
        ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_plain, 3, 5, 244),
        ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_plain, 4, 6, 278),
    ):
        flops = n_products * one_product
        nbytes = n_tensors * tensor_bytes + 3 * row_bytes  # q,k,v,dO + outputs; lse, delta, dlse
        rows.append(dict(
            name=name, source=f"modal_examples_tpu_torch/csrc/{name}.cu",
            replaces=f"modal_examples_tpu/ops/flash_attention.py:{line}",
            ms=time_ms(lambda: fn(*args, causal=True, sm_scale=D**-0.5)),
            ms_b2b=back_to_back_ms(lambda: fn(*args, causal=True, sm_scale=D**-0.5)),
            plain_ms=time_ms(lambda: plain(*args, causal=True, sm_scale=D**-0.5), reps=5),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
            library_ms=library_ms, library_ms_b2b=library_ms_b2b,
            library_op="aten._scaled_dot_product_flash_attention_backward (dQ, dK and dV together)",
        ))
    del args, q, k, v, do, out
    rows += int8_rows(pa, gen)
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = counts[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
        log(f"{r['name']}: {r['ms']:.4f} ms, back-to-back {r['ms_b2b']:.4f}, device {r.get('device_ms')} (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, back-to-back {r.get('library_ms_b2b')}, bound {r['bound_ms']:.4f} by {r['bound_by']})"
            + (f"; device time and bound by shape {r['shapes']}" if "shapes" in r else ""))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "ms_b2b", "device_ms", "plain_ms",
            "bound_ms",
            "bound_by", "library_ms", "library_ms_b2b", "library_op", "bf16_mm_ms", "bf16_mm_ms_b2b", "shape", "path",
            "prefill", "shapes", "unfolded_device_ms", "unfolded_ms", "unfolded_ms_b2b", "equal_to_unfolded")
    return [{k: r[k] for k in keys if k in r} for r in rows]


def folded_timing(pa, gen, per_layer: list, nbytes: int) -> dict:
    """K4 with the folded write at phase 5's K4 shape (``per_layer``: each
    cycled layer's arguments): each layer's 8 new rows, where each context's
    last row sits, written by K4 itself, against the sequence it replaces,
    K3 over the one-layer view and then K4, on the same inputs; device time
    (the sequence's as the sum of its two launches' readings, each in a
    window of its own: one window over both once read less than K4 alone),
    single-launch time, and the byte bound with the new rows read once and
    written once."""
    q, _, _, tables, ctx = per_layer[0]
    B, Hkv = q.shape[0], per_layer[0][1].shape[2]
    pos = (ctx - 1).long()
    page_idx = tables.gather(1, (pos // 16)[:, None])[:, 0].int().contiguous()
    slot = (pos % 16).int()
    news = [(rand_bf16(gen, B, Hkv, 128), rand_bf16(gen, B, Hkv, 128)) for _ in per_layer]

    def fold(a, n):
        return pa.paged_decode_writeback_cuda(*a, sm_scale=128**-0.5, k_new=n[0], v_new=n[1], page_idx=page_idx,
                                              slot=slot)

    def unfold(a, n):
        pa.scatter_kv_layer(a[1], a[2], n[0], n[1], page_idx, slot)
        return pa.paged_decode_writeback_cuda(*a, sm_scale=128**-0.5)

    folded = cycling([lambda a=a, n=n: fold(a, n) for a, n in zip(per_layer, news)])
    unfolded = cycling([lambda a=a, n=n: unfold(a, n) for a, n in zip(per_layer, news)])
    scatters = cycling([lambda a=a, n=n: pa.scatter_kv_layer(a[1], a[2], n[0], n[1], page_idx, slot)
                        for a, n in zip(per_layer, news)])
    attends = cycling([lambda a=a: pa.paged_decode_writeback_cuda(*a, sm_scale=128**-0.5) for a in per_layer])
    a0, n0 = per_layer[0], news[0]
    unfolded_parts = (device_ms(scatters), device_ms(attends))
    out = dict(device_ms=device_ms(folded), unfolded_device_ms=None if None in unfolded_parts else sum(unfolded_parts),
               ms=time_ms(folded),
               unfolded_ms=time_ms(unfolded), ms_b2b=back_to_back_ms(folded),
               unfolded_ms_b2b=back_to_back_ms(unfolded),
               plain_ms=time_ms(lambda: pa.paged_decode_writeback_plain(
                   *a0, sm_scale=128**-0.5, k_new=n0[0], v_new=n0[1], page_idx=page_idx, slot=slot), reps=5),
               bound_ms=1e3 * (nbytes + 2 * 2 * B * Hkv * 128 * 2) / PEAK_BYTES, bound_by="bytes",
               equal_to_unfolded=bool(torch.equal(fold(per_layer[0], news[0]), unfold(per_layer[0], news[0]))))
    if not out["equal_to_unfolded"]:
        raise AssertionError("phase 5: the folded K4 is not bitwise K3 -> K4 on the timed inputs")
    return out


def scatter_row(pa, gen, int8: bool) -> dict:
    """Phase 5's row of K3 or K3-int8 (``scatter_timed``): single-launch,
    back-to-back and device times, the plain version and one library call at
    the decode shape; the device time and the byte bound at every shape of
    ``SCATTER_SHAPES`` under ``shapes``."""
    from modal_examples_tpu_torch.ops import kv_quant as kvq

    shapes = {}
    for shape, (L, N) in SCATTER_SHAPES.items():
        t = scatter_timed(pa, gen, shape, int8)
        shapes[shape] = dict(L=L, N=N, device_ms=device_ms(t["launch"]), bound_ms=1e3 * t["nbytes"] / PEAK_BYTES)
        if shape != "decode":
            del t
            continue
        kp, vp = t["pages"]
        k_all, v_all, page_idx, slot = t["sets"][0]
        layer_ix = torch.arange(L, device="cuda")[:, None]
        pi, sl = page_idx.long()[None], slot.long()[None]

        def library():
            for pages, new in ((kp, k_all), (vp, v_all)):
                if int8:
                    q = kvq.quantize_kv(new)
                    pages.data.index_put_((layer_ix, pi, sl), q.data)
                    pages.scale.index_put_((layer_ix, pi, sl), q.scale)
                else:
                    pages.index_put_((layer_ix, pi, sl), new)

        decode = dict(
            ms=time_ms(t["launch"]), ms_b2b=back_to_back_ms(t["launch"]), device_ms=shapes[shape]["device_ms"],
            plain_ms=time_ms(t["plain"]), bound_ms=shapes[shape]["bound_ms"],
            library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library),
        )
        del t, kp, vp, k_all, v_all
    name = "kv_scatter_int8" if int8 else "kv_scatter"
    return dict(
        name=name, source=f"modal_examples_tpu_torch/csrc/{name}.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:927",
        shape="L={} N={} Hkv=32 D=128, {} sets of rows and targets in turn".format(*SCATTER_SHAPES["decode"], SCATTER_SETS),
        **decode, bound_by="bytes",
        library_op=("quantize_kv + index_put_ (int8 rows and scales, K and V)" if int8
                    else "index_put_ (K and V)"),
        shapes=shapes,
    )


def cycling(fns):
    """One callable that calls ``fns`` in turn: timed over weight copies that
    together exceed the 50 MB L2, so each launch streams its weight from HBM
    as a decode step does."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def int8_library(w):
    """One PyTorch call computing the int8 matmul's function on ``w``:
    ``torch._weight_int8pack_mm`` (weight [N, K], bf16 scales) where this
    build has it for CUDA, else ``torch.mm`` over a bf16 weight dequantized
    beforehand. Returns (fn of x, name)."""
    from modal_examples_tpu_torch.models.quantize import dequantize_weight

    wt, s = w.q.T.contiguous(), w.scale.reshape(-1).to(torch.bfloat16)
    probe = torch.zeros((8, w.q.shape[0]), dtype=torch.bfloat16, device="cuda")
    try:
        torch._weight_int8pack_mm(probe, wt, s)
        torch.cuda.synchronize()
        return (lambda x: torch._weight_int8pack_mm(x, wt, s)), "torch._weight_int8pack_mm (scales rounded to bf16, bf16 out)"
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"library probe: torch._weight_int8pack_mm has no CUDA path here ({type(e).__name__}: {str(e)[:160]})")
    wd = dequantize_weight(w, torch.bfloat16)
    return (lambda x: torch.mm(x, wd)), "torch.mm over a bf16 weight dequantized beforehand"


def int8_rows(pa, gen) -> list:
    """Phase 5 rows of the int8 kernels: K7 at the decode step's and the
    prefill batch's gate/up shape, K2-int8 at K2's shape, K4-int8 at K4's,
    K3-int8 at ``SCATTER_SHAPES``."""
    from modal_examples_tpu_torch.models.quantize import dequantize_weight, quantize_weight
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    rows = []
    K, N = 4096, 11008
    weights = [quantize_weight(torch.randn(K, N, generator=gen, device="cuda")) for _ in range(4)]  # 180 MB of int8
    libs = [int8_library(w) for w in weights]
    # a second yardstick: the bf16 GEMM (cuBLAS) the bf16 path runs on the same shape
    bf16_weights = [dequantize_weight(w, torch.bfloat16) for w in weights]
    timed = {}
    for label, M in (("decode", 8), ("prefill", 2048)):
        x = rand_bf16(gen, M, K)
        flops, nbytes = 2 * M * N * K, M * K * 2 + K * N + N * 4 + M * N * 4  # x, q, scale in; f32 out
        kernel = cycling([lambda w=w: qmm.qmm_cuda(x, w.q, w.scale) for w in weights])
        library = cycling([lambda fn=fn: fn(x) for fn, _ in libs])
        bf16_mm = cycling([lambda wd=wd: torch.mm(x, wd) for wd in bf16_weights])
        timed[label] = dict(
            shape=f"M={M} K={K} N={N}", path=qmm.kernel_path(x, weights[0].q),
            ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel),
            plain_ms=time_ms(cycling([lambda w=w: qmm.qmm_plain(x, w.q, w.scale) for w in weights]), reps=5),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
            library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library),
            library_op=libs[0][1],
            bf16_mm_ms=time_ms(bf16_mm), bf16_mm_ms_b2b=back_to_back_ms(bf16_mm),
        )
    rows.append(dict(
        name="quantized_matmul", source="modal_examples_tpu_torch/csrc/quantized_matmul.cu",
        replaces="modal_examples_tpu/ops/quantized_matmul.py:38", **timed["decode"], prefill=timed["prefill"],
    ))
    del weights, libs, bf16_weights
    # K2-int8 at K2's shape: 8 slots, ragged prefixes 0..1000, int8 pages,
    # cycled over four layers of one cache
    c = decode_case(gen, 8, 32, 32, L=32, int8=True)
    per_layer = [decode_args(c, li) for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_int8_cuda(*a, sm_scale=128**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum())
    nbytes = 2 * rows_read * 32 * (128 + 4) + 4 * 8 * 32 * 128 * 2  # int8 K+V rows and scales; q, o, k_new, v_new
    rows.append(dict(
        name="paged_decode_int8", source="modal_examples_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:284",
        shape=f"B=8 Hq=Hkv=32 D=128 prefixes 0..1000 ({rows_read} rows), layers {CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_int8_plain(*per_layer[0], sm_scale=128**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    # K4-int8 at K4's shape over the same int8 layers' pages: contexts are
    # K2-int8's prefixes plus the current token
    per_layer = [[c["q"], c["k_pages"][li], c["v_pages"][li], c["page_tables"], c["prefix_lens"] + 1]
                 for li in CYCLED_LAYERS]
    kernel = cycling([lambda a=a: pa.paged_decode_writeback_int8_cuda(*a, sm_scale=128**-0.5) for a in per_layer])
    rows_read = int(c["prefix_lens"].sum()) + 8
    nbytes = 2 * rows_read * 32 * (128 + 4) + 2 * 8 * 32 * 128 * 2  # int8 K+V rows and scales; q, o
    rows.append(dict(
        name="paged_decode_writeback_int8", source="modal_examples_tpu_torch/csrc/paged_decode_writeback_int8.cu",
        replaces="modal_examples_tpu/ops/paged_attention.py:72",
        shape=f"B=8 Hq=Hkv=32 D=128 one layer's int8 pages, contexts 1..1001 ({rows_read} rows), layers "
              f"{CYCLED_LAYERS} in turn",
        ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: pa.paged_decode_writeback_int8_plain(*per_layer[0], sm_scale=128**-0.5), reps=5),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", library_ms=None, library_ms_b2b=None,
        library_op="none: no PyTorch call attends over a paged cache",
    ))
    del c, per_layer, kernel
    rows.append(scatter_row(pa, gen, int8=True))
    return rows


# -- phase 15: the failure and fleet layers ------------------------------------------

#: the migrations' wire chunk on the card: a 7B block of phase 3's longest
#: prompt is ~360 MB of bf16, ~90 chunks of this size
FLEET_CHUNK_BYTES = 4 << 20
#: phase 15c's live migrations start once each moved request has this many tokens
MIGRATE_AFTER_TOKENS = 2
#: the watchdog's poll on the card (its thresholds are the reference's defaults)
WATCHDOG_POLL_S = 0.1


def fleet_counts(fa, pa, qmm) -> dict:
    return {k: v for k, v in spec_counts(fa, pa, qmm).items() if v}


def wait_for(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def rows_of(reqs) -> list:
    return [(list(r.generated_tokens), r.finish_reason) for r in reqs]


def hold_rows(reqs, ref_rows: list, label: str) -> int:
    """Greedy and seeded rows token-identical to ``ref_rows`` (rows with an
    engine-assigned seed draw a new one per engine and are skipped), every
    finish reason equal. Returns the rows held."""
    held = 0
    for r, (toks, fin) in zip(reqs, ref_rows):
        if r.finish_reason != fin:
            raise AssertionError(f"{label}: {r.request_id} finished {r.finish_reason}, the reference {fin}")
        if r.params.temperature > 0 and r.params.seed is None:
            continue
        if list(r.generated_tokens) != toks:
            raise AssertionError(f"{label}: {r.request_id} tokens differ from the reference run")
        held += 1
    log(f"{label}: {held} greedy and seeded rows token-identical to the reference run")
    return held


def fleet_unified_alone(LLMEngine, cfg, params, kv: str, requests) -> tuple:
    """The held reference: one unified engine serving each request alone (as
    ``prefill_sync`` prefills it), and the burst's texts."""
    free_fleet()
    eng = LLMEngine(cfg, params, kv_dtype=kv, **SERVE_KW)
    try:
        reqs, texts = [], []
        for p, sp in requests:
            r = eng.submit(p, sp)
            texts.append("".join(eng.stream(r)))
            check_finish(r)
            reqs.append(r)
        check_pages_returned(eng, f"15b unified alone ({kv})")
    finally:
        eng.stop()
    return reqs, texts


def phase15_codec(LLMEngine, cfg, params, kv: str, prompt: str, sp, card: str) -> dict:
    """15a: phase 3's 700-token prompt prefilled on one card engine, its pages
    extracted, serialized, deserialized and adopted into a second engine's
    cache (bitwise); the card's bytes against the same pages copied page by
    page into a CPU cache and serialized there."""
    from modal_examples_tpu_torch.serving.disagg import transport as tr
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    free_fleet()
    src = LLMEngine(cfg, params, kv_dtype=kv, **SERVE_KW)
    dst = LLMEngine(cfg, params, kv_dtype=kv, **SERVE_KW)
    try:
        req = src.make_request(prompt, sp)
        state = src.prefill_sync(req)
        ids = state["claim"]["pages"][: state["n_kv_pages"]]
        torch.cuda.synchronize()
        secs = {}
        t = time.perf_counter()
        block = src.extract_request_pages(req, state)  # one gather and one copy to the host a leaf
        secs["extract"] = time.perf_counter() - t
        t = time.perf_counter()
        wire = tr.serialize_block(block)
        secs["serialize"] = time.perf_counter() - t
        t = time.perf_counter()
        back = tr.deserialize_block(wire)
        secs["deserialize"] = time.perf_counter() - t
        new = dst.cache.allocator.alloc(len(ids))
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.adopt_pages(dst.cache, back, new)
        torch.cuda.synchronize()
        secs["adopt"] = time.perf_counter() - t
        src_ids = torch.tensor(ids, device=src.device)
        dst_ids = torch.tensor(new, device=dst.device)
        leaves = []
        for (name, a), (name_b, b) in zip(tr.wire_leaves(src.cache), tr.wire_leaves(dst.cache)):
            if name != name_b or not torch.equal(a.index_select(1, src_ids), b.index_select(1, dst_ids)):
                raise AssertionError(f"15a ({kv}): adopted leaf {name} is not the source's pages bitwise")
            leaves.append(name)
        # the same pages through the CPU: copied page by page into a CPU cache
        host = PagedKVCache.create(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                   n_pages=len(ids) + 1, page_size=src.cache.page_size, kv_dtype=kv, device="cpu")
        for (_, card_leaf), (_, host_leaf) in zip(tr.wire_leaves(src.cache), tr.wire_leaves(host)):
            for j, p in enumerate(ids):
                host_leaf[:, j + 1].copy_(card_leaf[:, p].cpu())
        host_wire = tr.serialize_block(tr.extract_pages(host, list(range(1, len(ids) + 1)),
                                                        block_hashes=block.block_hashes, meta=block.meta))
        if host_wire != wire:
            raise AssertionError(f"15a ({kv}): the card's block differs from the CPU round trip's bytes")
        if block.meta["position"] != len(req.prompt_tokens) or block.n_pages != len(ids):
            raise AssertionError(f"15a ({kv}): block meta {block.meta['position']} / {block.n_pages} pages")
        src.release_claim(state["claim"])
        dst.cache.allocator.free(new)
        nbytes = block.nbytes()
        out = {
            "kv_dtype": kv, "card": card, "pages": len(ids), "leaves": leaves, "block_bytes": nbytes,
            "wire_bytes": len(wire), "seconds": secs,
            "gb_per_s": {k: (len(wire) if k in ("serialize", "deserialize") else nbytes) / v / 1e9
                         for k, v in secs.items()},
        }
    finally:
        src.stop()
        dst.stop()
    log(f"15a codec ({kv}, {card}): {len(ids)} pages, {len(wire)} wire bytes, bitwise on the card and equal to "
        f"the CPU round trip's bytes; {json.dumps(out)}")
    return out


def fleet(LLMEngine, cfg, params, kv: str):
    """One prefill replica (its loop never runs) and two decode replicas
    over the one set of weights, behind a ``DisaggCoordinator``."""
    from modal_examples_tpu_torch.scheduling.router import EngineReplica
    from modal_examples_tpu_torch.serving.disagg import DisaggCoordinator

    free_fleet()
    reps = [EngineReplica(LLMEngine(cfg, params, kv_dtype=kv, **SERVE_KW), name, role=role)
            for name, role in (("prefill-0", "prefill"), ("decode-a", "decode"), ("decode-b", "decode"))]
    for r in reps:  # one set of weights: no engine holds a copy
        if r.engine.params["layers"][0]["wq"].data_ptr() != params["layers"][0]["wq"].data_ptr():
            raise AssertionError(f"phase 15: {r.name}'s engine copied the weights")
    return DisaggCoordinator(reps, chunk_bytes=FLEET_CHUNK_BYTES), reps


def free_fleet() -> None:
    """Collect the engines of the step before (their caches sit in reference
    cycles until a collection) before the next step builds its own."""
    gc.collect()
    torch.cuda.empty_cache()


def owner_and_peer(co, reqs) -> tuple:
    owners = {r._router_replica.name for r in reqs}
    if len(owners) != 1:
        raise AssertionError(f"the burst landed on {owners}: want one decode replica")
    (owner,) = owners
    a = next(r for r in co.replicas if r.name == owner)
    b = next(r for r in co.replicas if r.serves_requests and r.name != owner)
    return a, b


def submit_through(co, requests) -> tuple:
    """Each request through the coordinator (its prefill, transfer and
    enqueue on the caller's thread); per request the seconds, pages and wire
    bytes migrated."""
    reqs, moved = [], []
    for p, sp in requests:
        pages0, bytes0 = co.pages_migrated, co.bytes_migrated
        t = time.monotonic()
        reqs.append(co.submit(p, sp))
        moved.append({"seconds": time.monotonic() - t, "pages": co.pages_migrated - pages0,
                      "wire_bytes": co.bytes_migrated - bytes0})
    return reqs, moved


def phase15_disagg(fa, pa, qmm, LLMEngine, cfg, params, kv: str, requests, ref_rows, card: str) -> dict:
    """15b: phase 3's burst through the coordinator, twice. Staged: every
    request prefilled and shipped while the decode loops are still stopped
    (the prefill side's launches), then decoded (the decode side's). Live:
    the decode loops running, the watchdog polling the decode replicas (every
    replica healthy throughout), per-request TTFT. Both token-identical to
    the unified engine serving each request alone; every page back."""
    from modal_examples_tpu_torch.serving.health import FleetWatchdog, progress_age, replica_snapshot

    co, reps = fleet(LLMEngine, cfg, params, kv)
    out: dict = {"kv_dtype": kv, "card": card}
    try:
        zero_counts(fa, pa, qmm)
        reqs, moved = submit_through(co, requests)
        prefill_side = fleet_counts(fa, pa, qmm)
        zero_counts(fa, pa, qmm)
        for r in reqs:
            "".join(co.stream(r))
            check_finish(r)
        settle(reqs[0]._router_replica.engine)
        decode_side = fleet_counts(fa, pa, qmm)
        scatter = "kv_scatter_int8" if kv == "int8" else "kv_scatter"
        decode_k = "paged_decode_int8" if kv == "int8" else "paged_decode"
        if not (prefill_side.get("flash_fwd", 0) > 0 and prefill_side.get(scatter, 0) > 0
                and not prefill_side.get(decode_k)):
            raise AssertionError(f"15b ({kv}) prefill side launches {prefill_side}: want K1 and K3, no decode")
        if not (decode_side.get(decode_k, 0) > 0 and decode_side.get(scatter, 0) > 0
                and not decode_side.get("flash_fwd")):
            raise AssertionError(f"15b ({kv}) decode side launches {decode_side}: want K2 and K3, no K1")
        out["staged"] = {"held": hold_rows(reqs, ref_rows, f"15b staged ({kv})"), "moved": moved,
                         "launches": {"prefill_side": prefill_side, "decode_side": decode_side}}
        launches = {k: prefill_side.get(k, 0) + decode_side.get(k, 0) for k in {*prefill_side, *decode_side}}
        for r in reps:
            check_pages_returned(r.engine, f"15b staged ({kv}) {r.name}")
        # live: the decode loops running, the watchdog over the decode replicas
        for e in co.serving_engines():
            e.start()
        wd = FleetWatchdog(co.router, poll_s=WATCHDOG_POLL_S, journal_path=ROOT / "build" / "state" / "fleet-15b.jsonl")
        states: set = set()
        ages: list = []
        polls = {"n": 0}
        real_poll = wd._poll_replica

        def poll(replica, now):  # record what the ladder saw, and the worst progress age
            acts = real_poll(replica, now)
            states.add(replica.health_state)
            polls["n"] += 1
            age = progress_age(replica_snapshot(replica, now))
            if age is not None:
                ages.append(age)
            return acts

        wd._poll_replica = poll
        wd.start()
        zero_counts(fa, pa, qmm)
        try:
            t0 = time.monotonic()
            reqs_live, moved_live = submit_through(co, requests)
            for r in reqs_live:
                "".join(co.stream(r))
                check_finish(r)
            wall = time.monotonic() - t0
            settle(reqs_live[0]._router_replica.engine)
            time.sleep(3 * WATCHDOG_POLL_S)
        finally:
            wd.stop()
        live_counts = fleet_counts(fa, pa, qmm)
        for k, v in live_counts.items():
            launches[k] = launches.get(k, 0) + v
        if states != {"healthy"} or any(e["action"] != "transition" or e["state"] != "healthy" for e in wd.events):
            raise AssertionError(f"15b ({kv}): the watchdog saw {states}, events {wd.events[-5:]}")
        stats = co.stats()["migrations"]
        if stats["ok"] != 2 * len(requests) or stats["fallback"] or stats["aborted"]:
            raise AssertionError(f"15b ({kv}) migrations {stats}")
        for r in reps:
            check_pages_returned(r.engine, f"15b live ({kv}) {r.name}")
        out["live"] = {
            "held": hold_rows(reqs_live, ref_rows, f"15b live ({kv})"),
            "ttft_s": [r.first_token_at - r.created for r in reqs_live],
            "moved": moved_live,
            "wall_s": wall,
            "burst_tok_per_s": sum(r.n_generated for r in reqs_live) / wall,
            "watchdog_polls": polls["n"],
            "watchdog_states": sorted(states),
            "watchdog_max_progress_age_s": max(ages, default=0.0),
            "launches": live_counts,
        }
        out["migrations"] = stats
        out["launches"] = launches
    finally:
        for r in reps:
            r.engine.stop()
    log(f"15b disaggregated serving ({kv}, {card}): {json.dumps(out)}")
    return out


def phase15_live_migration(fa, pa, qmm, co, requests, ref_rows, ref_texts, card: str) -> dict:
    """15c: the burst decoding on decode replica A; the 4 longest prompts'
    requests, each past its first tokens, moved to B with ``migrate_live``
    (four threads, so one scheduler tick detaches them all): their tokens
    and texts identical to the unmigrated rows. The burst is placed while the
    decode loops are stopped, so every request starts decoding in the same
    tick and the moved ones are mid-decode when the moves land, however fast
    a replica decodes."""
    import threading

    for e in co.serving_engines():
        e.stop()
    zero_counts(fa, pa, qmm)
    reqs, _ = submit_through(co, requests)
    a, b = owner_and_peer(co, reqs)
    for e in (a.engine, b.engine):
        e.start()
    pieces = [[] for _ in reqs]
    readers = [threading.Thread(target=lambda i=i: pieces[i].extend(co.stream(reqs[i]))) for i in range(len(reqs))]
    for t in readers:
        t.start()
    longest = sorted(range(len(reqs)), key=lambda i: -len(reqs[i].prompt_tokens))[:4]
    wait_for(lambda: all(len(reqs[i].generated_tokens) >= MIGRATE_AFTER_TOKENS for i in longest), 120,
             "the migrated requests' first tokens")
    blocks = []
    real_out = a.engine.migrate_out

    def migrate_out(req, **kw):  # the blocks' sizes, for the log
        kind, block = real_out(req, **kw)
        if block is not None:
            blocks.append({"pages": block.n_pages, "bytes": block.nbytes(), "position": block.meta["position"],
                           "generated": len(block.meta["resume"]["generated"])})
        return kind, block

    a.engine.migrate_out = migrate_out
    results, secs = [None] * 4, [0.0] * 4

    def move(j, i):
        t = time.monotonic()
        results[j] = co.migrate_live(reqs[i], b.name)
        secs[j] = time.monotonic() - t

    movers = [threading.Thread(target=move, args=(j, i)) for j, i in enumerate(longest)]
    for t in movers:
        t.start()
    for t in movers + readers:
        t.join(timeout=600)
    del a.engine.migrate_out
    if results != ["ok"] * 4:
        raise AssertionError(f"15c: migrate_live results {results}: want four mid-decode moves")
    moved_to_b = [reqs[i]._router_replica.name for i in longest]
    if moved_to_b != [b.name] * 4:
        raise AssertionError(f"15c: owners after the moves {moved_to_b}")
    for r in reqs:
        check_finish(r)
    held = hold_rows(reqs, ref_rows, "15c live migration")
    texts = ["".join(p) for p in pieces]
    for i, (t, want) in enumerate(zip(texts, ref_texts)):
        if reqs[i].params.seed is not None or reqs[i].params.temperature == 0:
            if t != want:
                raise AssertionError(f"15c: request {i}'s streamed text differs from the reference's")
    for eng in (a.engine, b.engine):
        settle(eng)
        check_pages_returned(eng, "15c")
    out = {"card": card, "moved": [reqs[i].request_id for i in longest], "source": a.name, "target": b.name,
           "seconds": secs, "blocks": blocks, "held": held, "launches": fleet_counts(fa, pa, qmm)}
    log(f"15c live migration ({card}): {json.dumps(out)}")
    return out


def phase15_router_front(fa, pa, qmm, co, OpenAIServer, requests, ref_rows, ref_texts, card: str) -> dict:
    """15f: ``OpenAIServer(router=coordinator)`` answers a completion and a
    stream over HTTP; the requests it placed (recorded by an instance wrapper
    on the coordinator's ``submit``) carry the unified run's tokens."""
    placed = []
    real_submit = co.submit

    def submit(*a, **kw):
        r = real_submit(*a, **kw)
        placed.append(r)
        return r

    co.submit = submit
    srv = OpenAIServer(router=co, model_name="llama2-7b", port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    zero_counts(fa, pa, qmm)
    try:
        bodies = []
        for i in (0, 2):
            p, sp = requests[i]
            bodies.append({"prompt": p, "max_tokens": sp.max_tokens, "temperature": sp.temperature,
                           "top_p": sp.top_p, "seed": sp.seed})
        status, headers, text = http(base, "/v1/completions", bodies[0])
        done = json.loads(text)
        streamed = stream_completion(base, dict(bodies[1], stream=True, stream_options={"include_usage": True}))
    finally:
        srv.stop()
        del co.submit
    if status != 200 or len(placed) != 2 or headers.get("x-mtpu-request-id") != placed[0].request_id:
        raise AssertionError(f"15f: status {status}, {len(placed)} placed, headers {headers}")
    got = [(done["choices"][0]["text"], done["choices"][0]["finish_reason"]),
           (streamed["text"], streamed["finish"])]
    for (r, (t, fin)), i in zip(zip(placed, got), (0, 2)):
        if (list(r.generated_tokens), r.finish_reason) != ref_rows[i] or t != ref_texts[i] or fin != ref_rows[i][1]:
            raise AssertionError(f"15f: request {i} through the router front differs from the unified run")
    out = {"card": card, "requests": [r.request_id for r in placed], "owners": [r._router_replica.name for r in placed],
           "launches": fleet_counts(fa, pa, qmm)}
    log(f"15f router front ({card}): a completion and a stream through OpenAIServer(router=...), tokens equal to "
        f"the unified run's; {json.dumps(out)}")
    return out


def phase15_failover(fa, pa, qmm, co, requests, ref_rows, ref_texts, card: str) -> dict:
    """15d: ``engine.scheduler_crash`` armed while only decode replica A's
    loop runs, once every request has its first tokens: the streams,
    consumed through ``stream_with_failover``, resume on B: the same request
    objects and ids, no duplicated character (the streamed texts equal the
    uninterrupted run's), tokens held to the uninterrupted run."""
    import threading

    from modal_examples_tpu_torch.faults import inject

    for e in co.serving_engines():
        e.stop()
    zero_counts(fa, pa, qmm)
    reqs, _ = submit_through(co, requests)
    ids = [r.request_id for r in reqs]
    a, b = owner_and_peer(co, reqs)
    a.engine.start()
    pieces = [[] for _ in reqs]
    readers = [threading.Thread(target=lambda i=i: pieces[i].extend(co.stream(reqs[i]))) for i in range(len(reqs))]
    for t in readers:
        t.start()
    wait_for(lambda: all(len(r.generated_tokens) >= MIGRATE_AFTER_TOKENS or r.finish_reason for r in reqs), 120,
             "the burst's first tokens")
    plan = inject.FaultPlan({"engine.scheduler_crash": {"on_hit": 1}}, seed=0)
    with inject.active(plan):
        wait_for(lambda: plan.fired().get("engine.scheduler_crash") == 1, 60, "the injected crash")
    generated_at_crash = [len(r.generated_tokens) for r in reqs]
    for t in readers:
        t.join(timeout=600)
    resumed = [r.request_id for r in reqs if r._router_replica is b]
    if not resumed or [r.request_id for r in reqs] != ids:
        raise AssertionError(f"15d: {len(resumed)} requests resumed on {b.name}")
    for r in reqs:
        check_finish(r)
    held = hold_rows(reqs, ref_rows, "15d reactive failover")
    # the held rows' streamed texts against the uninterrupted run's: equal
    # texts leave no duplicated (and no missing) character
    texts = ["".join(p) for p in pieces]
    kept = [i for i, r in enumerate(reqs) if r.params.seed is not None or r.params.temperature == 0]
    dup = sum(max(0, len(texts[i]) - len(ref_texts[i])) for i in kept)
    if dup or any(texts[i] != ref_texts[i] for i in kept):
        raise AssertionError(f"15d: streamed texts differ from the uninterrupted run's ({dup} extra characters)")
    for eng in (a.engine, b.engine):
        settle(eng)
        check_pages_returned(eng, "15d")
    out = {"card": card, "victim": a.name, "target": b.name, "resumed": resumed, "generated_at_crash":
           generated_at_crash, "duplicated_chars": dup, "held": held, "exempted_positions": [],
           "launches": fleet_counts(fa, pa, qmm)}
    log(f"15d reactive failover ({card}): {json.dumps(out)}")
    return out


def phase15_health(fa, pa, qmm, co, requests, card: str) -> dict:
    """15e: ``engine.scheduler_freeze`` armed while only decode replica A's
    loop runs a request: under a ``FleetWatchdog`` at the reference's
    thresholds A goes degraded (its router weight drops to 0.25, and a new
    request lands on B) and then wedged (the ladder error-stops it and the
    frozen stream resumes on B); the gateway's ``/health`` route and
    ``python -m modal_examples_tpu_torch health`` show it."""
    import threading

    from modal_examples_tpu_torch import App
    from modal_examples_tpu_torch.faults import inject
    from modal_examples_tpu_torch.serving.health import FleetWatchdog, WatchdogPolicy
    from modal_examples_tpu_torch.web.gateway import Gateway

    for e in co.serving_engines():
        e.stop()
    zero_counts(fa, pa, qmm)
    p, sp = requests[7]
    long_sp = dataclasses.replace(sp, max_tokens=SERVE_KW["max_model_len"] - 1 - 700)
    req = co.submit(p, long_sp)
    (a, b) = owner_and_peer(co, [req])
    a.engine.start()
    pieces: list = []
    reader = threading.Thread(target=lambda: pieces.extend(co.stream(req)))
    reader.start()
    wait_for(lambda: len(req.generated_tokens) >= MIGRATE_AFTER_TOKENS, 120, "the frozen request's first tokens")
    policy = WatchdogPolicy()
    wd = FleetWatchdog(co.router, policy=policy, poll_s=WATCHDOG_POLL_S).start()
    t_freeze = time.monotonic()
    try:
        plan = inject.FaultPlan({"engine.scheduler_freeze": {"on_hit": 1}}, seed=0)
        with inject.active(plan):
            wait_for(lambda: plan.fired().get("engine.scheduler_freeze") == 1, 60, "the injected freeze")
        # the watchdog publishes the state before it journals the transition
        # and down-weights the replica: wait for the whole rung
        wait_for(lambda: a.health_state == "degraded" and co.router.health_weight(a.name) != 1.0,
                 policy.degraded_after_s + 10, f"{a.name} degraded and down-weighted")
        t_degraded = time.monotonic() - t_freeze
        weight = co.router.health_weight(a.name)
        fresh = co.submit(*requests[0])
        landed = fresh._router_replica.name
        fresh_text = "".join(co.stream(fresh))
        wait_for(lambda: a.health_state == "wedged", policy.wedged_after_s + 10, f"{a.name} wedged")
        t_wedged = time.monotonic() - t_freeze
        reader.join(timeout=600)
        gw = Gateway(App("smoke-fleet")).start()
        try:
            code, view = http_json(gw.base_url + "/health")
        finally:
            gw.stop()
    finally:
        wd.stop()
    cli = subprocess.run([sys.executable, "-m", "modal_examples_tpu_torch", "health"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120, env=dict(os.environ))
    actions = [(e.get("action"), e.get("state")) for e in wd.events if e.get("replica") == a.name]
    peer_events = [e for e in wd.events if e.get("replica") == b.name]
    if peer_events:
        raise AssertionError(f"15e: the peer {b.name} left healthy: {peer_events}")
    if weight != policy.degraded_weight or landed != b.name:
        raise AssertionError(f"15e: {a.name} degraded at weight {weight}, the new request landed on {landed}")
    if ("transition", "degraded") not in actions or ("transition", "wedged") not in actions or \
            ("stop_revive", None) not in actions:
        raise AssertionError(f"15e: the ladder's actions on {a.name}: {actions}")
    if req.finish_reason not in ("length", "stop") or req._router_replica is not b:
        raise AssertionError(f"15e: the frozen stream ended {req.finish_reason} on {req._router_replica.name}")
    if code != 200 or view["replicas"].get(a.name, {}).get("state") != "wedged":
        raise AssertionError(f"15e: /health answered {code}: {view}")
    if cli.returncode != 0 or "wedged" not in cli.stdout or a.name not in cli.stdout:
        raise AssertionError(f"15e: the health CLI printed {cli.stdout[-800:]} {cli.stderr[-800:]}")
    for e in co.serving_engines():
        e.stop()
    a.engine.revive()
    for eng in (a.engine, b.engine):
        check_pages_returned(eng, "15e")
    out = {"card": card, "frozen": a.name, "peer": b.name, "degraded_after_s": t_degraded,
           "wedged_after_s": t_wedged, "weight_degraded": weight, "new_request_on": landed,
           "ladder": actions, "health_route": view["replicas"], "fresh_chars": len(fresh_text),
           "frozen_request": {"finish": req.finish_reason, "generated": len(req.generated_tokens)},
           "launches": fleet_counts(fa, pa, qmm)}
    log(f"15e health ({card}): {json.dumps(out)}\n{cli.stdout}")
    return out


def phase_fleet_layers(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, params, phase3_rows,
                       card: str) -> dict:
    """Phase 15: the failure and fleet layers over phase 3's resident bf16
    weights (every engine built over that one set; none copies it): 15a the
    MTKV1 codec on the card, 15b disaggregated serving, 15c live migration,
    15f the router front, 15d reactive failover, 15e the watchdog; then 15a
    and 15b again over int8 pages."""
    cfg = llama.LlamaConfig.llama2_7b()
    requests = make_requests(SamplingParams)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    out: dict = {"card": card}
    launches: dict = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    uni, texts = fleet_unified_alone(LLMEngine, cfg, params, "bfloat16", requests)
    ref_rows = rows_of(uni)
    # the burst's engine-seeded rows drew other seeds: greedy and seeded rows compared
    kept = [i for i, (_, sp) in enumerate(requests) if sp.seed is not None or sp.temperature == 0]
    same = all((list(phase3_rows[i][0]), phase3_rows[i][1]) == ref_rows[i] for i in kept)
    log(f"15b finding: each request served alone {'equals' if same else 'differs from'} phase 3's batched burst "
        f"token for token ({card})")
    out["alone_equals_phase3_burst"] = same
    out["codec"] = {"bfloat16": phase15_codec(LLMEngine, cfg, params, "bfloat16", *requests[7], card)}
    out["disagg"] = {"bfloat16": phase15_disagg(fa, pa, qmm, LLMEngine, cfg, params, "bfloat16", requests, ref_rows,
                                                card)}
    add(out["disagg"]["bfloat16"]["launches"])
    co, reps = fleet(LLMEngine, cfg, params, "bfloat16")
    try:
        out["live_migration"] = phase15_live_migration(fa, pa, qmm, co, requests, ref_rows, texts, card)
        add(out["live_migration"]["launches"])
        out["router_front"] = phase15_router_front(fa, pa, qmm, co, OpenAIServer, requests, ref_rows, texts, card)
        add(out["router_front"]["launches"])
        out["failover"] = phase15_failover(fa, pa, qmm, co, requests, ref_rows, texts, card)
        add(out["failover"]["launches"])
        out["health"] = phase15_health(fa, pa, qmm, co, requests, card)
        add(out["health"]["launches"])
    finally:
        for r in reps:
            r.engine.stop()
    del co, reps
    out["peak_gb_bf16"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    uni8, _ = fleet_unified_alone(LLMEngine, cfg, params, "int8", requests)
    out["codec"]["int8"] = phase15_codec(LLMEngine, cfg, params, "int8", *requests[7], card)
    out["disagg"]["int8"] = phase15_disagg(fa, pa, qmm, LLMEngine, cfg, params, "int8", requests, rows_of(uni8), card)
    add(out["disagg"]["int8"]["launches"])
    for k in ("flash_fwd", "paged_decode", "kv_scatter", "paged_decode_int8", "kv_scatter_int8"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"phase 15: {k} never launched: {launches}")
    out["launches"] = launches
    out["weights_gb"] = weights_gb
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15 the failure and fleet layers ({card}): ok in {out['seconds']:.1f}s, weights {weights_gb:.2f} GB, "
        f"peak {out['peak_gb']:.2f} GB; launches {launches}")
    return out


# -- phase 16 ---------------------------------------------------------------------

#: 16c: the fleet's model, Llama-2-7B at full width cut to phase 14's depth
FLEET_DEPTH = SNAP_DEPTH
#: 16c: live streams on the scale-in victim, and their length
DRAIN_STREAMS, DRAIN_TOKENS = 2, 160


class TierClock:
    """Wall seconds and bytes of each step of a tiered engine's spill and
    promote: wrappers on ``tiered_cache``'s module names and on the store's
    ``put``/``get`` of one engine (the adopt synchronizes the card, so its
    copies are timed)."""

    STEPS = ("extract", "serialize", "demote", "volume_read", "deserialize", "adopt")

    def __init__(self, eng):
        from modal_examples_tpu_torch.serving.disagg import tiered_cache as tc

        self.tc, self.eng = tc, eng
        self.seconds = dict.fromkeys(self.STEPS, 0.0)
        self.bytes = dict.fromkeys(self.STEPS, 0)
        self._saved = {}

    def _wrap(self, owner, name: str, step: str, nbytes, sync: bool = False):
        fn = getattr(owner, name)
        self._saved[(owner, name)] = fn

        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            self.seconds[step] += time.perf_counter() - t
            self.bytes[step] += nbytes(a, out)
            return out

        setattr(owner, name, timed)

    def __enter__(self):
        tc, store = self.tc, self.eng.tiered.store
        self._wrap(tc, "extract_pages", "extract", lambda a, out: out.nbytes())
        self._wrap(tc, "serialize_block", "serialize", lambda a, out: len(out))
        self._wrap(store, "put", "demote", lambda a, out: len(a[1]) if out == "written" else 0)
        self._wrap(store, "get", "volume_read", lambda a, out: len(out) if out else 0)
        self._wrap(tc, "deserialize_block", "deserialize", lambda a, out: out.nbytes())
        self._wrap(tc, "adopt_pages", "adopt", lambda a, out: a[1].nbytes(), sync=True)
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in self._saved.items():
            if owner is self.tc:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)  # the instance attribute shadowed the method
        return False

    def report(self) -> dict:
        return {s: {"s": self.seconds[s], "bytes": self.bytes[s],
                    "gb_per_s": self.bytes[s] / 1e9 / self.seconds[s] if self.seconds[s] else None}
                for s in self.STEPS}


def trie_page_ids(eng, tokens) -> list:
    pages, _ = eng.prefix_cache.acquire(tokens)
    eng.prefix_cache.release(pages)
    return pages


def page_bytes(eng, ids) -> dict:
    """Every leaf of ``ids`` on the host (bf16 as int16 bits: compared with ``torch.equal``)."""
    from modal_examples_tpu_torch.serving.disagg import extract_pages

    block = extract_pages(eng.cache, ids)
    return {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).clone() for k, v in block.leaves.items()}


def same_bytes(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def tier_rows(SamplingParams) -> list:
    """Phase 6b's 320-token shared prompt (20 full pages) alone, in the
    sampling of its 8 rows (the engine-seeded ones given a seed, so every
    row can be held)."""
    reqs = shared_prefix_requests(SamplingParams)
    system = reqs[0][0][: SYSTEM_TOKENS - 1]
    return [(system, SamplingParams(max_tokens=sp.max_tokens, temperature=sp.temperature,
                                    seed=700 + i if sp.seed is None else sp.seed)) for i, (_, sp) in enumerate(reqs)]


def serve_rows(eng, rows, label: str, first_alone: bool = True) -> tuple:
    """``rows`` through ``eng``, the first alone (its TTFT timed), the rest
    as one burst; every finish checked, every page back."""
    reqs = [eng.make_request(p, sp) for p, sp in rows]
    head = reqs[:1] if first_alone else []
    for group in (head, reqs[len(head):]):
        for r in group:
            eng.submit_request(r)
        for r in group:
            "".join(eng.stream(r))
            check_finish(r)
    settle(eng)
    check_pages_returned(eng, label)
    return reqs, reqs[0].first_token_at - reqs[0].created


def phase16_tiers(fa, pa, qmm, LLMEngine, cfg, params, SamplingParams, kv: str, card: str) -> dict:
    """16a over one kv dtype: the rows with the cache off (the reference),
    then through a tiered engine: served, the 20 pages recorded, spilled,
    served again (promoted bitwise before and after the prefill's rewrite,
    the reference's tokens, ``cached_tokens`` = promoted pages x 16)."""
    from modal_examples_tpu_torch.storage.volume import Volume

    rows = tier_rows(SamplingParams)
    free_fleet()
    off = LLMEngine(cfg, params, kv_dtype=kv, enable_prefix_cache=False, **SERVE_KW)
    try:
        off.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
        ref, ttft_off = serve_rows(off, rows, f"16a cache off ({kv})")
    finally:
        off.stop()
    del off
    free_fleet()
    vol_cm = Volume.ephemeral()
    vol = vol_cm.__enter__()
    eng = LLMEngine(cfg, params, kv_dtype=kv, tiered_prefix={"volume": vol, "shared": True, "replica": "a"},
                    **SERVE_KW)
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    zero_counts(fa, pa, qmm)
    first, _ = serve_rows(eng, rows, f"16a tiered round 1 ({kv})")
    tokens = first[0].prompt_tokens
    ids = trie_page_ids(eng, tokens)
    if len(ids) != SYSTEM_TOKENS // 16:
        raise AssertionError(f"16a ({kv}): {len(ids)} trie pages for the shared prompt, want {SYSTEM_TOKENS // 16}")
    recorded = page_bytes(eng, ids)
    page_nbytes = sum(v.nbytes for v in recorded.values()) // len(ids)
    with TierClock(eng) as spill_clock:
        t = time.perf_counter()
        eng.prefix_cache.evict(10_000)
        spill_s = time.perf_counter() - t
    st = eng.tiered.stats()
    split = {"host": st["host"]["blocks"], "volume": st["volume"]["blocks"]}
    log(f"16a spill ({kv}, {card}): {len(ids)} pages of {page_nbytes} B in {spill_s:.3f}s, split {split}, "
        f"host {st['host']['bytes']} B of {st['host']['budget_bytes']}; steps {json.dumps(spill_clock.report())}")
    promoted = []
    promote = eng.tiered.promote

    def watch(key_tokens, *, n_have):
        got = promote(key_tokens, n_have=n_have)
        if got and not promoted:
            promoted.append((list(got), page_bytes(eng, got)))
        return got

    eng.tiered.promote = watch
    with TierClock(eng) as promote_clock:
        second, ttft_promoted = serve_rows(eng, rows, f"16a tiered round 2 ({kv})")
    del eng.tiered.promote
    counts = fleet_counts(fa, pa, qmm)
    st2 = eng.tiered.stats()
    if not promoted or len(promoted[0][0]) != len(ids) or not same_bytes(promoted[0][1], recorded):
        raise AssertionError(f"16a ({kv}): the promoted pages are not the recorded ones, bitwise")
    after = page_bytes(eng, trie_page_ids(eng, tokens))
    if not same_bytes(after, recorded):
        raise AssertionError(f"16a ({kv}): the pages changed when prefill rewrote them over the promotion")
    if second[0].cached_prompt_tokens != len(promoted[0][0]) * 16:
        raise AssertionError(f"16a ({kv}): cached_tokens {second[0].cached_prompt_tokens}, "
                             f"{len(promoted[0][0])} pages promoted")
    held = hold_rows(first, rows_of(ref), f"16a round 1 ({kv})") + hold_rows(second, rows_of(ref),
                                                                            f"16a round 2 ({kv})")
    hits = st2["hits"]
    if hits["host"] != split["host"] or hits["volume"] != split["volume"]:
        raise AssertionError(f"16a ({kv}): tier hits {hits}, the spill split {split}")
    out = {
        "page_bytes": page_nbytes, "pages": len(ids), "split": split, "hits": hits, "rows_held": held,
        "spill_s": spill_s, "spill": spill_clock.report(), "promote": promote_clock.report(),
        "ttft_promoted_s": ttft_promoted, "ttft_cache_off_s": ttft_off, "launches": counts,
        "cached_tokens": second[0].cached_prompt_tokens, "card": card,
    }
    log(f"16a tiers ({kv}, {card}): promoted {len(ids)} pages bitwise before and after the rewrite, split "
        f"{split}, hits {hits}, TTFT promoted {ttft_promoted:.3f}s vs cache off {ttft_off:.3f}s; promote steps "
        f"{json.dumps(out['promote'])}; launches {counts}")
    return out, eng, (vol_cm, vol), rows, ref


def phase16_replicas(fa, pa, qmm, LLMEngine, cfg, params, eng_a, vol, rows, ref, card: str) -> dict:
    """16b over the bf16 store of 16a: replica "b" promotes what "a"
    demoted (peer volume hits), ``tiered.volume_corrupt`` drops a block in
    flight and recomputes (the stored file untouched), and
    ``prefix_store.owner_death`` kills the chain's owner mid-spill: the
    survivor takes the lease over and promotes warm."""
    import hashlib

    from modal_examples_tpu_torch.faults import inject
    from modal_examples_tpu_torch.faults.chaos import _force_spill as force_spill
    from modal_examples_tpu_torch.observability.journal import named_journal

    out: dict = {}
    zero_counts(fa, pa, qmm)
    force_spill(eng_a)  # every block of the chain on the shared volume
    eng_b = LLMEngine(cfg, params, tiered_prefix={"volume": vol, "shared": True, "replica": "b"}, **SERVE_KW)
    try:
        got, _ = serve_rows(eng_b, rows, "16b replica b")
        st = eng_b.tiered.stats()
        if st["hits"]["volume"] <= 0 or st["store"]["hits"]["peer"] <= 0:
            raise AssertionError(f"16b: replica b had no volume hit from a's spill: {st['hits']} {st['store']['hits']}")
        out["cross_replica"] = {"hits": st["hits"], "peer_hits": st["store"]["hits"]["peer"],
                                "rows_held": hold_rows(got, rows_of(ref), "16b replica b")}
        # in-flight corruption: the promote drops the block, prefill recomputes
        force_spill(eng_b)
        store = eng_b.tiered.store
        digests = {h: hashlib.sha256((vol.local_path / store._rel(h)).read_bytes()).hexdigest()
                   for h in sorted(store._index) if store.exists(h)}
        plan = inject.FaultPlan({"tiered.volume_corrupt": {"on_hit": 1}})
        with inject.active(plan):
            got, _ = serve_rows(eng_b, rows, "16b volume corrupt")
        after = {h: hashlib.sha256((vol.local_path / store._rel(h)).read_bytes()).hexdigest()
                 for h in digests if store.exists(h)}
        if plan.fired() != {"tiered.volume_corrupt": 1} or after != digests or got[0].cached_prompt_tokens:
            raise AssertionError(f"16b volume corrupt: fired {plan.fired()}, stored files kept "
                                 f"{after == digests}, cached_tokens {got[0].cached_prompt_tokens}")
        out["volume_corrupt"] = {"fired": plan.fired(), "stored_files_kept": len(after),
                                 "rows_held": hold_rows(got, rows_of(ref), "16b volume corrupt")}
        # owner death: both replicas warm on the chain, the owner dies mid-spill
        serve_rows(eng_a, rows[:1], "16b warm a", first_alone=False)
        for e in (eng_a, eng_b):
            e.prefix_cache.evict(10_000)
            e.tiered.store.heartbeat()
        head = chain_head(eng_a, rows)
        owner = eng_a.tiered.store.owner_for(head)
        dead, survivor = (eng_a, eng_b) if owner == "a" else (eng_b, eng_a)
        n0 = len(named_journal("prefix_store").tail(1 << 20))
        base = survivor.tiered.store.board.takeovers
        plan = inject.FaultPlan({"prefix_store.owner_death": {"on_hit": 1}})
        with inject.active(plan):
            # the chaos runner's owner-death leg: the owner's blocks dropped
            # from the store first, so its demotes are writes, not dedup skips
            force_spill(dead, rewrite=True, only_chain=head)
            force_spill(survivor, only_chain=head)
            dead.tiered.store.register_replica()
            vol_hits = survivor.tiered.stats()["hits"]["volume"]
            got, _ = serve_rows(survivor, rows, "16b owner death survivor")
        takeovers = [r for r in named_journal("prefix_store").tail(1 << 20)[n0:] if r["action"] == "owner_takeover"]
        warm = survivor.tiered.stats()["hits"]["volume"] - vol_hits
        if plan.fired() != {"prefix_store.owner_death": 1} or survivor.tiered.store.board.takeovers <= base \
                or not takeovers or warm <= 0:
            raise AssertionError(f"16b owner death: fired {plan.fired()}, takeovers {takeovers}, warm hits {warm}")
        out["owner_death"] = {"dead": dead.tiered.store.replica, "survivor": survivor.tiered.store.replica,
                              "takeover": {k: takeovers[0][k] for k in ("from", "to", "reason")},
                              "warm_volume_hits": warm, "rows_held": hold_rows(got, rows_of(ref), "16b owner death")}
    finally:
        eng_b.stop()
    out["launches"] = fleet_counts(fa, pa, qmm)
    out["card"] = card
    log(f"16b across replicas and under faults ({card}): {json.dumps(out)}")
    return out


def chain_head(eng, rows) -> str:
    """The chained hash of the shared prompt's first page."""
    from modal_examples_tpu_torch.serving.disagg.transport import chain_hashes

    return chain_hashes(eng.make_request(rows[0][0], trace=None).prompt_tokens, 16)[0]


def phase16_fleet(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, gw, card: str) -> dict:
    """16c: ``FleetAutoscaler`` over a ``PrefixAffinityRouter`` of
    Llama-2-7B-width replicas at depth 4, built by a ``SnapshotWarmFactory``
    and driven by ``tick()`` under a fake clock: a 16-request burst over 8
    slots raises a queue scale-up whose replica boots warm from the snapshot
    and serves the seed's rows; idle ticks raise a scale-down whose victim's
    live streams migrate through ``drain_replica`` to the seed, token for
    token, its engine stopped at zero outstanding; ``fleet.jsonl`` and
    ``/fleet`` agree; one load-generator step through the fleet's server."""
    import threading

    from modal_examples_tpu_torch.fleet import FleetAutoscaler, SnapshotWarmFactory
    from modal_examples_tpu_torch.fleet import loadgen
    from modal_examples_tpu_torch.observability.journal import named_journal
    from modal_examples_tpu_torch.scheduling.router import EngineReplica, PrefixAffinityRouter
    from modal_examples_tpu_torch.snapshot import SnapshotStore
    from modal_examples_tpu_torch.utils import tree

    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=FLEET_DEPTH)
    snap_dir = ROOT / "build" / f"fleet-snap-{os.getpid()}"
    engines = []
    boots: dict = {}

    def build(name, role, params=None):
        t = time.perf_counter()
        eng = LLMEngine(cfg, params, **SERVE_KW)
        torch.cuda.synchronize()
        boots[name] = {"build_s": time.perf_counter() - t, "warm": params is not None}
        engines.append(eng)
        return EngineReplica(eng, name, role=role)

    n_journal = len(named_journal("fleet").tail(1 << 20))
    factory = SnapshotWarmFactory(build, snapshot_key=f"smoke-fleet-{os.getpid()}", store=SnapshotStore(root=snap_dir))
    out: dict = {"card": card, "depth": FLEET_DEPTH}
    clock = FakeClock()
    try:
        t = time.perf_counter()
        seed, boot = factory("decode-0", "decode")
        out["cold_boot_s"] = time.perf_counter() - t  # build + capture of the snapshot
        if boot != "cold" or not factory.store.has(factory.snapshot_key):
            raise AssertionError(f"16c: the seed booted {boot}, snapshot captured {factory.store.has(factory.snapshot_key)}")
        out["snapshot_bytes"] = factory.store.entries()[0]["size_bytes"]
        router = PrefixAffinityRouter([seed])
        auto = FleetAutoscaler(router, factory, up_ticks=1, down_ticks=1, cooldown_s=0.0, slos=(), clock=clock,
                               max_replicas={"decode": 2})
        seed.engine.start()
        burst = burst16(SamplingParams)
        zero_counts(fa, pa, qmm)
        reqs = [seed.submit(p, sp) for p, sp in burst]
        acts = auto.tick()
        if [(a["action"], a["trigger"], a["boot"]) for a in acts] != [("scale_up", "queue_pressure", "warm")]:
            raise AssertionError(f"16c: the burst's tick decided {acts}")
        grown = router.replicas[-1]
        out["warm_boot_s"] = acts[0]["boot_s"]
        out["scale_up"] = {k: acts[0][k] for k in ("trigger", "boot", "queued", "replicas_after")}
        for r in reqs:
            "".join(seed.engine.stream(r))
            check_finish(r)
        a, b = tree.leaves(seed.engine.params), tree.leaves(grown.engine.params)
        if len(a) != len(b) or any(not torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("16c: the warm replica's weights differ from the seed's")
        again = [grown.submit(p, sp) for p, sp in burst[:8]]
        for r in again:
            "".join(grown.engine.stream(r))
            check_finish(r)
        out["warm_rows_held"] = hold_rows(again, rows_of(reqs[:8]), "16c warm replica against the seed")
        # drain by migration: live streams on the scale-in victim move to the seed
        long = [(p, SamplingParams(max_tokens=DRAIN_TOKENS, temperature=0.0)) for p, _ in burst[:DRAIN_STREAMS]]
        ref = [seed.submit(p, sp) for p, sp in long]
        for r in ref:
            "".join(seed.engine.stream(r))
        live = [grown.submit(p, sp) for p, sp in long]
        readers = [threading.Thread(target=lambda r=r: "".join(grown.engine.stream(r))) for r in live]
        for th in readers:
            th.start()
        wait_for(lambda: all(len(r.generated_tokens) >= MIGRATE_AFTER_TOKENS for r in live), 60, "16c live streams")
        clock.t += 1.0
        acts = auto.tick()
        if [(a["action"], a["replica"]) for a in acts] != [("scale_down", grown.name)]:
            raise AssertionError(f"16c: the idle tick decided {acts}")
        t = time.monotonic()
        while auto._draining and time.monotonic() - t < 120:
            clock.t += 1.0
            auto.tick()
            time.sleep(0.02)
        for th in readers:
            th.join(timeout=120)
        if auto._draining or grown.outstanding() or grown.engine._running:
            raise AssertionError(f"16c: the victim did not drain ({grown.outstanding()} outstanding)")
        out["drained_rows_held"] = hold_rows(live, rows_of(ref), "16c drained streams against the seed")
        records = named_journal("fleet").tail(1 << 20)[n_journal:]
        migrated = sum(r.get("migrated", 0) for r in records if r["action"] == "drain_migrate")
        if migrated != DRAIN_STREAMS:
            raise AssertionError(f"16c: {migrated} streams migrated, want {DRAIN_STREAMS}: {records}")
        decisions = sorted((r["action"], r["trigger"]) for r in records if r["action"] in ("scale_up", "scale_down"))
        code, fleet_view = http_json(gw.base_url + "/fleet?n=50")
        served = sorted((act, trig) for act, by in fleet_view["decisions"].items() for trig, n in by.items()
                        for _ in range(int(n)))
        if code != 200 or served != decisions or decisions != [("scale_down", "idle"), ("scale_up", "queue_pressure")]:
            raise AssertionError(f"16c: /fleet answered {code} {fleet_view['decisions']}, the journal {decisions}")
        out["journal"] = [{k: r.get(k) for k in ("action", "trigger", "replica", "boot", "migrated",
                                                  "tokens_migrated")} for r in records]
        out["launches_burst_and_drain"] = fleet_counts(fa, pa, qmm)
        srv = OpenAIServer(router=router, port=0).start()
        try:
            gen = loadgen.LoadGenerator(f"http://127.0.0.1:{srv.port}", seed=0)
            gen.warm()
            out["loadgen"] = gen.run_step(4.0, 3.0, label="4rps")
        finally:
            srv.stop()
        auto.stop(drain=True)
    finally:
        for eng in engines:
            eng.stop()
        shutil.rmtree(snap_dir, ignore_errors=True)
    out["launches"] = fleet_counts(fa, pa, qmm)
    step = out["loadgen"]
    log(f"16c fleet autoscaler ({card}): cold boot {out['cold_boot_s']:.2f}s (build {boots['decode-0']['build_s']:.2f}s "
        f"+ capture of {out['snapshot_bytes'] / 1e9:.3f} GB), warm boot {out['warm_boot_s']:.2f}s (build "
        f"{boots[grown.name]['build_s']:.2f}s after the restore); loadgen step {json.dumps(step)}; {json.dumps(out)}")
    return out


def phase16_chaos(fa, pa, qmm, gw, card: str) -> dict:
    """16d: the chaos runner on the card at the reference's fleet shapes
    (``LlamaConfig.tiny``, head dim 32): every fault point fired, the
    invariants "ok" after each episode, zero wedged; ``/chaos`` answers."""
    from modal_examples_tpu_torch.faults import ALL_FAULT_POINTS
    from modal_examples_tpu_torch.faults.chaos import run_chaos

    zero_counts(fa, pa, qmm)
    t = time.monotonic()
    report = run_chaos(seed=0, strict=True)
    seconds = time.monotonic() - t
    launches = fleet_counts(fa, pa, qmm)
    if report["points_missed"] or set(report["points_fired"]) != set(ALL_FAULT_POINTS) or report["wedged"] \
            or report["invariants"] != "ok" or any(ep["invariants"] != "ok" for ep in report["episodes"]):
        raise AssertionError(f"16d chaos: {json.dumps(report)[:2000]}")
    code, view = http_json(gw.base_url + "/chaos?n=20")
    if code != 200 or view["wedged"] != 0 or [e["episode"] for e in view["episodes"]][-len(report["episodes"]):] \
            != [e["episode"] for e in report["episodes"]]:
        raise AssertionError(f"16d: /chaos answered {code}: {view}")
    out = {"seconds": seconds, "episodes": {ep["episode"]: ep["invariants"] for ep in report["episodes"]},
           "points_fired": len(report["points_fired"]), "injected_total": report["injected_total"],
           "recovered": report["recovered"], "wedged": report["wedged"], "launches": launches, "card": card}
    log(f"16d chaos ({card}): {len(report['episodes'])} episodes ok in {seconds:.1f}s, "
        f"{out['points_fired']} points fired, 0 wedged; launches {launches}")
    return out


def phase_tiers_fleet_chaos(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, params, card: str) -> dict:
    """Phase 16: the prefix tiers (16a, 16b) over phase 3's resident bf16
    weights, the fleet autoscaler (16c) at depth 4, the chaos runner (16d)."""
    from modal_examples_tpu_torch import App
    from modal_examples_tpu_torch.web.gateway import Gateway

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    out: dict = {"card": card, "tiers": {}}
    launches: dict = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    tier, eng_a, (vol_cm, vol), rows, ref = phase16_tiers(fa, pa, qmm, LLMEngine, cfg, params, SamplingParams,
                                                          "bfloat16", card)
    out["tiers"]["bfloat16"] = tier
    add(tier["launches"])
    try:
        out["replicas"] = phase16_replicas(fa, pa, qmm, LLMEngine, cfg, params, eng_a, vol, rows, ref, card)
        add(out["replicas"]["launches"])
    finally:
        eng_a.stop()
        vol_cm.__exit__(None, None, None)
    del eng_a
    tier8, eng8, (vol8, _), _, _ = phase16_tiers(fa, pa, qmm, LLMEngine, cfg, params, SamplingParams, "int8", card)
    eng8.stop()
    vol8.__exit__(None, None, None)
    del eng8
    out["tiers"]["int8"] = tier8
    add(tier8["launches"])
    out["peak_gb_tiers"] = torch.cuda.max_memory_allocated() / 1e9
    free_fleet()
    gw = Gateway(App("smoke-fleet")).start()
    try:
        out["fleet"] = phase16_fleet(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, gw, card)
        add(out["fleet"]["launches"])
        free_fleet()
        out["chaos"] = phase16_chaos(fa, pa, qmm, gw, card)
        add(out["chaos"]["launches"])
    finally:
        gw.stop()
    for k in ("flash_fwd", "paged_decode", "kv_scatter", "paged_decode_int8", "kv_scatter_int8"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"phase 16: {k} never launched: {launches}")
    out["launches"] = launches
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.monotonic() - t0
    free_fleet()
    log(f"phase 16 the prefix tiers, the fleet autoscaler and the chaos runner ({card}): ok in "
        f"{out['seconds']:.1f}s, peak {out['peak_gb']:.2f} GB; launches {launches}")
    return out


# -- phase 17: int4 weights, QLoRA, DreamBooth-LoRA, ControlNet and Whisper training --------

#: Mixtral's expert products K7-int4 takes at decode (M = 8)
QMM4_EXPERT = ((4096, 14336), (14336, 4096))
#: K7-int4's timed shape (gate/up of Llama-2-7B) at the decode step and the prefill batch
QMM4_TIMED = (4096, 11008)
QMM4_TIMED_MS = (("decode", 8), ("prefill", 2048))
#: phase 12's int8-base LoRA peak on an H100 (16.18 GB, PERF.md §6): 17c's
#: bound when phase 17 runs alone; the whole script holds 17c to its phase 12
INT8_LORA_PEAK_GB = 16.18
#: 17b: int4 weights at most this share of the int8 engine's (the payload
#: is exactly half; the f32 scales and the bf16 embeddings and norms stay)
INT4_WEIGHT_RATIO_MAX = 0.53
#: 17c QLoRA: 1 warm-up and 2 timed steps (phase 12 takes 3 timed)
QLORA_STEPS = 3
#: 17d DreamBooth-LoRA on the SD3-shape MMDiT: the batch (512 px latents,
#: 154 text tokens: the joint S is 1178) and 1 warm-up + 2 timed steps
DREAMBOOTH_B = 2
DREAMBOOTH_STEPS = 3
DREAMBOOTH_TEXT = 154
#: 17e: controlnet.py's DiT config and batch; whisper-base fine-tuned on
#: 2 x 30 s of audio with 32 tokens, 2 Trainer steps each
CONTROLNET_CFG = dict(img_size=16, patch=2, dim=96, n_layers=3, n_heads=4, text_dim=16, text_len=4, control=True)
CONTROLNET_B = 16
WHISPER_FT = (2, 3000, 32)
FT_STEPS = 2


def int4_planted_faults(qmm, x, w, want, x_prefill, want_prefill) -> dict:
    """Three faults K7-int4's check must refuse, run through the kernel: at
    the decode step (the ring path) the packed nibbles read in the swapped
    order (each byte's halves exchanged) and the last K split of the
    launch's plan lost (the K rows of that split zeroed in ``x``: the sum
    without that split's partial); at the prefill batch (the wgmma path) the
    last K tile lost (its rows zeroed in ``x``: the ring's last turn
    dropped)."""
    plan = qmm.int4_plan(x, w.q)
    if plan["splits"] < 2 or plan["path"] != "ring":
        raise AssertionError(f"17a: the planted split fault wants a split launch on the ring: {plan}")
    prefill = qmm.int4_plan(x_prefill, w.q)
    if prefill["path"] != "wgmma":
        raise AssertionError(f"17a: the planted prefill fault wants the wgmma path: {prefill}")
    swapped = ((w.q & 0xF) << 4) | (w.q >> 4)
    lost = x.clone()
    lost[:, (plan["splits"] - 1) * plan["chunk"] * plan["k_tile"]:] = 0
    lost_tile = x_prefill.clone()
    lost_tile[:, (prefill["chunk"] - 1) * prefill["k_tile"]:] = 0
    faults = {"nibbles swapped": rel_err(qmm.qmm_int4_cuda(x, swapped, w.scale), want),
              "last K split lost": rel_err(qmm.qmm_int4_cuda(lost, w.q, w.scale), want),
              "prefill: last K tile lost": rel_err(qmm.qmm_int4_cuda(lost_tile, w.q, w.scale), want_prefill)}
    torch.cuda.synchronize()
    if not min(faults.values()) > TOL["quantized_matmul"]:
        raise AssertionError(f"17a: the K7-int4 check does not see a planted fault: {faults}")
    return {**faults, "plan": plan, "prefill_plan": prefill}


def int4_library(w, x):
    """One PyTorch call computing K7-int4's function on ``w``:
    ``torch._weight_int4pack_mm`` with the per-channel scales repeated over
    128-row groups and zero points 0 (its dequantization is (u - 8) * scale
    + zero over unsigned nibbles u = q + 8), where this build has it for
    CUDA and its output agrees with the plain version (its scales and output
    are bf16). Returns (fn of x, name), or (None, why not)."""
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    K, N = w.shape
    u = (w.values().to(torch.int32) + 8).T.contiguous()  # [N, K] unsigned nibbles
    group = 128
    sz = torch.stack([w.scale.reshape(1, N).expand(K // group, N), torch.zeros(K // group, N, device="cuda")],
                     dim=-1).to(torch.bfloat16).contiguous()
    want = qmm.qmm_int4_plain(x, w.q, w.scale)
    tried = []
    for order, packed in (("even row high", (u[:, 0::2] << 4) | u[:, 1::2]), ("even row low", (u[:, 1::2] << 4) | u[:, 0::2])):
        try:
            wp = torch._convert_weight_to_int4pack(packed.to(torch.uint8).contiguous(), 8)
            got = torch._weight_int4pack_mm(x, wp, group, sz)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
            tried.append(f"{order}: {type(e).__name__}: {str(e)[:160]}")
            continue
        rel = rel_err(got, want)
        tried.append(f"{order}: max|out-plain|/max|plain| {rel:.3g}")
        if rel < 2e-2:  # bf16 scales and output
            return (lambda xx: torch._weight_int4pack_mm(xx, wp, group, sz)), \
                f"torch._weight_int4pack_mm (groups of {group}, per-channel scales repeated, zero points 0; " \
                f"bf16 scales and output; nibbles {order}; {rel:.3g} of the plain version's largest value)"
    log(f"17a library probe: torch._weight_int4pack_mm does not compute the function here: {tried}")
    return None, f"none: torch._weight_int4pack_mm does not compute it here ({'; '.join(tried)})"


def phase17_matmul(qmm, quantize, errs: dict, card: str) -> dict:
    """17a: K7-int4 against ``qmm_int4_plain`` at M = 1, 8, 64, 65, 300 and
    2048 over every Llama-2-7B weight shape and a ragged 4000 x 11000, and
    at Mixtral's expert shapes at M = 8: within 1e-3 of the plain version's
    largest value, bitwise from launch to launch, each launch on the path
    its shape must take (``qmm.int4_kernel_path`` equal to the Python rule
    ``qmm.int4_path_rule``: "ring" at M <= 64 and "wgmma" above for every
    model shape, "masked" for the ragged one); the check shown to refuse
    three planted faults; ``quantize_weight(bits=4)`` on the card bitwise
    equal to the same call on the CPU (nibbles and scales). Then K7-int4's
    numbers at the decode step's and the prefill batch's gate/up shape, four
    weight copies in turn (90 MB of nibbles, beyond the 50 MB L2)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    out: dict = {"shapes": {}, "paths": {}}
    for K, N in QMM_SHAPES + [(K, N) for K, N in QMM4_EXPERT]:
        w32 = torch.randn(K, N, generator=gen, device="cuda")
        w = quantize.quantize_weight(w32, bits=4)
        host = quantize.quantize_weight(w32.cpu(), bits=4)
        if not (torch.equal(w.q.cpu(), host.q) and torch.equal(w.scale.cpu(), host.scale)):
            raise AssertionError(f"17a: quantize_weight(bits=4) of {K} x {N} on the card differs from the CPU's")
        del w32, host
        worst, paths, decode = 0.0, {}, None
        for M in (8,) if (K, N) in QMM4_EXPERT else QMM_MS:
            x = rand_bf16(gen, M, K)
            path = qmm.int4_kernel_path(x, w.q)
            want_path = "masked" if (K, N) == QMM_SHAPES[-1] else "wgmma" if M > 64 else "ring"
            if not path == qmm.int4_path_rule(x, w.q) == want_path:
                raise AssertionError(f"17a K7-int4 M={M} K={K} N={N}: path {path}, rule "
                                     f"{qmm.int4_path_rule(x, w.q)}, want {want_path}")
            paths[M] = path
            got = qmm.qmm_int4_cuda(x, w.q, w.scale)
            again = qmm.qmm_int4_cuda(x, w.q, w.scale)
            torch.cuda.synchronize()
            want = qmm.qmm_int4_plain(x, w.q, w.scale)
            rel = rel_err(got, want)
            plan = qmm.int4_plan(x, w.q)
            if not rel <= TOL["quantized_matmul"] or not torch.equal(got, again):
                raise AssertionError(f"17a K7-int4 M={M} K={K} N={N} {plan}: {rel}, bitwise {torch.equal(got, again)}")
            errs["quantized_matmul_int4"] = max(errs.get("quantized_matmul_int4", 0.0), max_err(got, want))
            worst = max(worst, rel)
            if (K, N) == QMM4_TIMED and M == 8:
                decode = (x, want)
            if (K, N) == QMM4_TIMED and M == 2048:
                out["faults"] = int4_planted_faults(qmm, decode[0], w, decode[1], x, want)
        out["shapes"][f"{K}x{N}"] = worst
        out["paths"][f"{K}x{N}"] = paths
        log(f"17a K7-int4 K={K} N={N}: worst max|out-plain|/max|plain| {worst:.3g} over M "
            f"{(8,) if (K, N) in QMM4_EXPERT else QMM_MS}, bitwise run to run; paths {paths}; "
            "card quantization = CPU's")
        del w
    log(f"17a planted faults (refused): {out['faults']}")
    K, N = QMM4_TIMED
    weights = [quantize.quantize_weight(torch.randn(K, N, generator=gen, device="cuda"), bits=4) for _ in range(4)]
    bf16_weights = [quantize.dequantize_weight(w, torch.bfloat16) for w in weights]
    for label, M in QMM4_TIMED_MS:
        x = rand_bf16(gen, M, K)
        flops, nbytes = 2 * M * N * K, K * N // 2 + 4 * N + 2 * M * K + 4 * M * N  # nibbles, scale, x in; f32 out
        kernel = cycling([lambda w=w: qmm.qmm_int4_cuda(x, w.q, w.scale) for w in weights])
        libs = [int4_library(weights[0], x)]
        if libs[0][0] is not None:
            libs += [int4_library(w, x) for w in weights[1:]]
        bf16_mm = cycling([lambda wd=wd: torch.mm(x, wd) for wd in bf16_weights])
        row = dict(
            shape=f"M={M} K={K} N={N}", plan=qmm.int4_plan(x, weights[0].q),
            ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=time_ms(cycling([lambda w=w: qmm.qmm_int4_plain(x, w.q, w.scale) for w in weights]), reps=5),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
            library_op=libs[0][1], bf16_mm_ms=time_ms(bf16_mm), bf16_mm_ms_b2b=back_to_back_ms(bf16_mm),
            bf16_mm_device_ms=device_ms(bf16_mm),
        )
        if libs[0][0] is None:
            row.update(library_ms=None, library_ms_b2b=None)
        else:
            library = cycling([lambda fn=fn: fn(x) for fn, _ in libs])
            row.update(library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library),
                       library_device_ms=device_ms(library))
        out[label] = row
        log(f"17a K7-int4 {label} ({card}): {json.dumps(row)}")
    del weights, bf16_weights
    return out


def int4_payload(params, quantize) -> tuple:
    """(packed int4 bytes, their elements) over every int4 weight of a tree."""
    ws = [w for w in quantize._weights(params) if w.bits == 4]
    return sum(w.q.numel() for w in ws), sum(w.shape.numel() for w in ws)


def phase17_serving(fa, pa, qmm, llama, layers, reference, quantize, LLMEngine, OpenAIServer, SamplingParams,
                    card: str) -> dict:
    """17b: ``llama2_7b()`` at full width and depth with int4 weights drawn
    by ``init_quantized_llama(bits=4)`` on the card, phase 3's engine
    settings and 8 requests over bf16 pages, counters zeroed just before the
    burst: K7-int4 a multiple of 7 x n_layers + 1 and at least that many a
    dispatched step, no K7, K2 n_layers x the dispatched steps, K1 and K3;
    weights at most 0.53 of the same tree's int8 bytes (the payload exactly
    half); prefill + one decode step against the dense plain forward over
    the same int4 weights; every greedy token the dense forward's argmax or
    within 5e-2 of its largest logit; then the server."""
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    q4 = quantize.init_quantized_llama(cfg, seed=0, bits=4, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    packed, elements = int4_payload(q4, quantize)
    w4 = quantize.param_bytes(q4)
    w8 = w4 + elements - packed  # the same tree at a byte an element
    ratio = w4 / w8
    log(f"17b int4 llama2-7b drawn in {init_s:.1f}s: {w4 / 1e9:.3f} GB ({ratio:.4f} of the int8 tree's "
        f"{w8 / 1e9:.3f} GB; payload {packed / 1e9:.3f} GB for {elements / 1e9:.3f}G elements)")
    if 2 * packed != elements or not ratio <= INT4_WEIGHT_RATIO_MAX:
        raise AssertionError(f"17b int4 bytes: payload {packed} for {elements} elements, {ratio} of int8")
    eng = LLMEngine(cfg, q4, **SERVE_KW)
    if eng.impl_plan["weights"] != "int4":
        raise AssertionError(f"17b plan {eng.impl_plan}")
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    zero_counts(fa, pa, qmm)
    qmm.qmm_int4_launches = 0
    reqs, metrics = serve_burst(eng, SamplingParams, "17b int4 engine")
    counts = {"flash_fwd": fa.launches, "quantized_matmul_int4": qmm.qmm_int4_launches,
              "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches,
              "quantized_matmul": qmm.qmm_launches}
    steps = metrics["dispatched_steps"]
    per_pass = 7 * cfg.n_layers + 1  # seven projections a layer, then lm_head
    log(f"17b int4 engine launches {counts}")
    if counts["paged_decode"] != cfg.n_layers * steps or counts["quantized_matmul"]:
        raise AssertionError(f"17b launches {counts}: want K2 {cfg.n_layers} x {steps}, no K7")
    if min(counts["flash_fwd"], counts["kv_scatter"]) < 1:
        raise AssertionError(f"17b: a kernel of the int4 path never launched: {counts}")
    if counts["quantized_matmul_int4"] % per_pass or counts["quantized_matmul_int4"] < per_pass * steps:
        raise AssertionError(f"17b K7-int4 launches {counts['quantized_matmul_int4']}: want a multiple of "
                             f"{per_pass}, at least {per_pass} x {steps} steps")
    metrics.update(launches=counts, k7_int4_per_pass=per_pass, weight_gb=w4 / 1e9, int8_tree_gb=w8 / 1e9,
                   weight_ratio=ratio, init_s=init_s)
    log(f"17b int4 engine metrics ({card}): {json.dumps(metrics)}")
    # outside the timed burst, each K7-int4 launch's path is counted: the
    # dense check's 128-row prefill and the server's requests
    with int4_path_tally(qmm) as tally:
        metrics["dense_check"] = check_against_dense(eng, llama, layers, reference)[0]
        metrics["exactness"] = check_spec_exactness(eng, reqs, layers, reference, "17b int4 greedy rows")
        before = qmm.qmm_int4_launches
        phase_server(eng, OpenAIServer)  # also stops the engine
    metrics["server_k7_int4"] = qmm.qmm_int4_launches - before
    metrics["k7_int4_paths"] = tally.paths
    if metrics["server_k7_int4"] < per_pass:
        raise AssertionError(f"17b: the server's requests launched K7-int4 {metrics['server_k7_int4']} times")
    if set(tally.paths) != {"wgmma", "ring"}:
        raise AssertionError(f"17b: K7-int4's launches by path {tally.paths}: want wgmma at prefill, ring at decode")
    metrics["launches"]["quantized_matmul_int4"] = qmm.qmm_int4_launches
    log(f"17b server: ok, K7-int4 {metrics['server_k7_int4']} launches; the dense check's and the server's "
        f"by path {tally.paths}")
    return metrics


class int4_path_tally:
    """K7-int4's wrapper wrapped for a ``with`` block outside the timed
    windows: each launch's path (``qmm.int4_kernel_path``, the kernel's own
    plan) counted into ``self.paths``, so a phase can show which path its
    launches took."""

    def __init__(self, qmm):
        self.qmm, self.kernel, self.paths = qmm, qmm.qmm_int4_cuda, {}

    def __enter__(self):
        def counted(x, w_packed, w_scale):
            path = self.qmm.int4_kernel_path(x, w_packed)
            self.paths[path] = self.paths.get(path, 0) + 1
            return self.kernel(x, w_packed, w_scale)

        self.qmm.qmm_int4_cuda = counted
        return self

    def __exit__(self, *exc):
        self.qmm.qmm_int4_cuda = self.kernel


class plain_int4_products:
    """K7-int4's plain version in place of its wrapper for a ``with`` block:
    17c's comparison path (the plain version counts no launch)."""

    def __init__(self, qmm):
        self.qmm, self.kernel = qmm, qmm.qmm_int4_cuda

    def __enter__(self):
        self.qmm.qmm_int4_cuda = self.qmm.qmm_int4_plain

    def __exit__(self, *exc):
        self.qmm.qmm_int4_cuda = self.kernel


def phase17_qlora(fa, qmm, llama, lora, training, quantize, int8_peak_gb: float, card: str) -> dict:
    """17c: QLoRA, phase 12 over an int4 base: ``init_quantized_llama(bits=4)``
    at Llama-2-7B's full width and depth, rank 16 on all seven projections
    (f32 adapters), B=2 x S=512. The first step's adapter gradients through
    K7-int4 and the flash kernels against ``qmm_int4_plain`` and the xla
    attention (cosine >= 0.999 per target); then, counters zeroed, 1
    warm-up and 2 timed ``Trainer`` steps: K7-int4 7 x n_layers + 1 times a
    step, K1, K5 and K6 n_layers times; the peak below the int8 base's."""
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    q4 = quantize.init_quantized_llama(cfg, seed=0, bits=4, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    _, lcfg, adapters, batches, loss_fn = lora_training_setup(llama, lora, training, q4, QLORA_STEPS)
    if any(v.dtype != torch.float32 for v in adapters["layers"].values()):
        raise AssertionError("17c: adapters over an int4 base must be f32")
    B, S = batches[0]["tokens"].shape
    log(f"17c QLoRA: llama2-7b int4 base ({quantize.param_bytes(q4) / 1e9:.3f} GB, drawn in {init_s:.1f}s), "
        f"rank {lcfg.rank} f32 on {lcfg.targets}, B={B} S={S}")
    with int4_path_tally(qmm) as tally:
        kernels = adapter_grads(loss_fn, adapters, batches[0], "flash")
    if set(tally.paths) != {"wgmma"}:
        raise AssertionError(f"17c: K7-int4's launches at M = {B * S} by path {tally.paths}: want wgmma only")
    log(f"17c K7-int4 launches of the gradient check by path: {tally.paths}")
    with plain_int4_products(qmm):
        plain = adapter_grads(loss_fn, adapters, batches[0], "xla")
    grads = compare_adapter_grads(kernels, plain, lcfg.targets, "K7-int4 + flash vs plain int4 products + xla")
    del kernels, plain
    gc.collect()
    torch.cuda.empty_cache()
    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    qmm.qmm_int4_launches = 0
    step_s, losses, per_step = [], [], []
    for batch in batches:
        before = qmm.qmm_int4_launches
        t1 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        losses.append(m["loss"].item())
        per_step.append(qmm.qmm_int4_launches - before)
    counts = {"quantized_matmul_int4": qmm.qmm_int4_launches, "flash_fwd": fa.launches,
              "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = 7 * cfg.n_layers + 1
    log(f"17c steps: loss {losses}, step s {step_s}, K7-int4 a step {per_step}, launches {counts}")
    if per_step != [want] * QLORA_STEPS:
        raise AssertionError(f"17c K7-int4 launches a step {per_step}: want {want}")
    if [counts[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] != [cfg.n_layers * QLORA_STEPS] * 3:
        raise AssertionError(f"17c flash launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"17c non-finite loss: {losses}")
    if min(state.params["layers"][f"{t}_b"].abs().max().item() for t in lcfg.targets) <= 0:
        raise AssertionError("17c: b adapters did not move off zero")
    if not peak < int8_peak_gb:
        raise AssertionError(f"17c QLoRA peak {peak:.2f} GB is not below the int8 base's {int8_peak_gb:.2f} GB")
    step_med = statistics.median(step_s[1:])
    out = {"train_tok_per_s": B * S / step_med, "step_ms_median": 1e3 * step_med, "step_ms": [1e3 * x for x in step_s],
           "losses": losses, "k7_int4_per_step": want, "peak_gb": peak, "int8_peak_gb": int8_peak_gb,
           "base_gb": quantize.param_bytes(q4) / 1e9, "launches": counts, "grad_check": grads}
    log(f"17c QLoRA ({card}): {out['train_tok_per_s']:.1f} tok/s, step {out['step_ms_median']:.1f} ms, peak "
        f"{peak:.2f} GB against the int8 base's {int8_peak_gb:.2f} GB; {json.dumps(out)}")
    return out


def joint_bwd_rows(fa, card: str) -> dict:
    """K5 and K6 at 17d's joint shape (B=2, H=24, S=1178, D=64, full):
    single, back-to-back and device ms, the plain version's, PyTorch's flash
    backward (dQ, dK and dV together) and the bounds."""
    B, H, S, D = DREAMBOOTH_B, 24, DREAMBOOTH_TEXT + 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(18)
    args, o = bwd_case(fa, gen, B, H, H, S, False, False, D)
    q, k, v, do = args[:4]
    out_l, lse_l, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, False, False, scale=D**-0.5)

    def library():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out_l, lse_l, cq, ck, mq, mk, 0.0, False, seed, offset, scale=D**-0.5)

    lib = dict(library_ms=time_ms(library), library_ms_b2b=back_to_back_ms(library), library_device_ms=device_ms(library))
    one_product = 2 * S * S * D * B * H
    tensor_bytes, row_bytes = B * H * S * D * 2, B * H * S * 4
    rows = {}
    for name, fn, plain, n_products, n_tensors in (
        ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_plain, 3, 5),
        ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_plain, 4, 6),
    ):
        flops, nbytes = n_products * one_product, n_tensors * tensor_bytes + 3 * row_bytes
        call = lambda fn=fn: fn(*args, causal=False, sm_scale=D**-0.5)  # noqa: E731
        rows[name] = dict(
            shape=f"B={B} H={H} S={S} ({DREAMBOOTH_TEXT} text + 1024 image) D={D}, full attention",
            ms=time_ms(call), ms_b2b=back_to_back_ms(call), device_ms=device_ms(call),
            plain_ms=time_ms(lambda plain=plain: plain(*args, causal=False, sm_scale=D**-0.5), reps=3),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes", **lib,
        )
    log(f"17d K5/K6 at the joint shape ({card}): {json.dumps(rows)}")
    return rows


def dreambooth_grads(fa, loss_fn, adapters, batch, reference=None) -> dict:
    """Adapter gradients of ``loss_fn`` (the flash entry, or ``reference``'s
    plain products in its place) keyed by path."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    leaves = [t.detach().requires_grad_(True) for t in tree_util.leaves(adapters)]
    real = fa.flash_attention
    if reference is not None:
        fa.flash_attention = lambda q, k, v, causal=True, sm_scale=None: reference.attention(q, k, v, causal=causal)
    try:
        loss = loss_fn(tree_util.unflatten(adapters, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        fa.flash_attention = real
    return tree_util.unflatten(adapters, list(grads))


def compare_tree_grads(kernel: dict, plain: dict, targets, label: str) -> dict:
    """Per target (its b-gradients over every block joined): cosine, held at
    ``GRAD_COSINE_MIN``, and max relative error; every a-gradient exactly
    zero (b = 0)."""
    def by_target(g):
        out: dict = {}
        for group in (g["blocks"], g.get("last_block", {})):
            for name, ab in group.items():
                if ab["a"].abs().max() != 0:
                    raise AssertionError(f"{label}: {name} a-gradient is not zero with b = 0")
                out.setdefault(name, []).append(ab["b"].float().flatten())
        return {k: torch.cat(v) for k, v in out.items()}

    kb, pb = by_target(kernel), by_target(plain)
    out = {}
    for t in targets:
        cos = torch.nn.functional.cosine_similarity(kb[t], pb[t], dim=0).item()
        out[t] = {"cosine": cos, "max_rel_err": max_err(kb[t], pb[t]) / pb[t].abs().max().item()}
    log(f"17d adapter gradients, {label}: {json.dumps(out)}")
    if not min(v["cosine"] for v in out.values()) >= GRAD_COSINE_MIN:
        raise AssertionError(f"17d adapter gradients disagree ({label}): {out}")
    return out


def phase17_dreambooth(fa, diffusion, lora, training, reference, card: str) -> dict:
    """17d: DreamBooth-LoRA on ``MMDiTConfig.sd3_shape()`` (2.03B, bf16; the
    zero-initialised modulation drawn nonzero), ``LoRAConfig(rank=16,
    alpha=32, targets=DIT_TARGETS)`` through ``init_lora_tree`` and
    ``merge_tree`` (with b = 0 the merged tree is the base, bitwise), B=2
    of 512 px latents and 154 text tokens (joint S = 1178), the
    ``mmdit_flow_loss`` over the merged tree. The first step's adapter
    gradients through K1 and K5/K6 against the same step with the plain
    attention products (cosine >= 0.999 per target); then, counters zeroed,
    1 warm-up and 2 timed ``Trainer`` steps (the port's AdamW): K1, K5 and
    K6 once a block a step."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    mcfg = diffusion.MMDiTConfig.sd3_shape()
    t0 = time.monotonic()
    base = diffusion.mmdit_init(mcfg, seed=0, device="cuda")
    open_the_gates(base, seed=1)
    lcfg = lora.LoRAConfig(rank=16, alpha=32, targets=lora.DIT_TARGETS)
    adapters = lora.init_lora_tree(torch.Generator(device="cuda").manual_seed(2), base, lcfg)
    merged = lora.merge_tree(base, adapters, lcfg)
    same = all(torch.equal(a, b) for a, b in zip(tree_util.leaves(merged), tree_util.leaves(base)))
    del merged
    if not same:
        raise AssertionError("17d: merge_tree with b = 0 is not the base, bitwise")
    n_base = sum(t.numel() for t in tree_util.leaves(base))
    n_lora = sum(t.numel() for t in tree_util.leaves(adapters))
    log(f"17d MMDiT sd3_shape {n_base / 1e9:.3f}B bf16 and {n_lora / 1e6:.2f}M adapter parameters in "
        f"{time.monotonic() - t0:.1f}s; merge_tree with b = 0 bitwise the base: {same}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, hw = DREAMBOOTH_B, mcfg.img_size
    batches = [{
        "latents": torch.randn((B, hw, hw, mcfg.channels), generator=gen, device="cuda"),
        "text": torch.randn((B, DREAMBOOTH_TEXT, mcfg.text_dim), generator=gen, device="cuda").to(torch.bfloat16),
        "pooled": torch.randn((B, mcfg.pooled_dim), generator=gen, device="cuda").to(torch.bfloat16),
        "t": torch.rand((B,), generator=gen, device="cuda"),
        "eps": torch.randn((B, hw, hw, mcfg.channels), generator=gen, device="cuda"),
    } for _ in range(DREAMBOOTH_STEPS)]

    def loss_fn(ad, b):
        return diffusion.mmdit_flow_loss(lora.merge_tree(base, ad, lcfg), b["latents"], b["text"], b["pooled"], mcfg,
                                         t=b["t"], eps=b["eps"])

    t0 = time.monotonic()
    kernel = dreambooth_grads(fa, loss_fn, adapters, batches[0])
    plain = dreambooth_grads(fa, loss_fn, adapters, batches[0], reference)
    grads = compare_tree_grads(kernel, plain, lcfg.targets, "K1 + K5/K6 vs the plain attention products")
    grad_s = time.monotonic() - t0
    del kernel, plain
    gc.collect()
    torch.cuda.empty_cache()
    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    step_s, losses = [], []
    for b in batches:
        t1 = time.monotonic()
        state, m = trainer.train_step(state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        losses.append(m["loss"].item())
    counts = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"17d steps: loss {losses}, step s {step_s}, launches {counts}")
    if counts != {k: mcfg.n_layers * DREAMBOOTH_STEPS for k in counts}:
        raise AssertionError(f"17d launches {counts}: want {mcfg.n_layers} x {DREAMBOOTH_STEPS} each")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"17d non-finite loss: {losses}")
    moved = min(ab["b"].abs().max().item() for ab in state.params["blocks"].values())
    if not moved > 0:
        raise AssertionError("17d: b adapters did not move off zero")
    step_med = statistics.median(step_s[1:])
    out = {"params_b": n_base / 1e9, "adapter_params_m": n_lora / 1e6, "batch": B, "joint_s": DREAMBOOTH_TEXT + 1024,
           "step_ms_median": 1e3 * step_med, "step_ms": [1e3 * x for x in step_s], "losses": losses,
           "peak_gb": peak, "grad_check_s": grad_s, "launches": counts, "grad_check": grads, "merge_bitwise": same}
    log(f"17d DreamBooth-LoRA ({card}): step {out['step_ms_median']:.1f} ms, peak {peak:.2f} GB; {json.dumps(out)}")
    del base, adapters, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    out["joint_bwd"] = joint_bwd_rows(fa, card)
    return out


def card_vs_cpu_step(loss_fn, params_cpu, batch_cpu, label: str) -> dict:
    """The first step's loss and gradients on the card against the same
    step on the CPU (same weights and inputs, f32, TF32 off): max abs <=
    ``CPU_AGREE``. Returns the readings."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    def step(params, batch):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_util.leaves(params)]
        loss = loss_fn(tree_util.unflatten(params, leaves), batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    to_card = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t  # noqa: E731
    lc, gc_ = step(params_cpu, batch_cpu)
    lg, gg = step(tree_util.map(to_card, params_cpu), tree_util.map(to_card, batch_cpu))
    loss_err = abs(lg.item() - lc.item())
    grad_err = max(max_err(a.cpu(), b) for a, b in zip(gg, gc_))
    grad_max = max(b.abs().max().item() for b in gc_)
    out = {"loss_card": lg.item(), "loss_cpu": lc.item(), "loss_abs_err": loss_err, "grad_max_abs_err": grad_err,
           "grad_largest": grad_max}
    log(f"17e {label}, card against CPU: {json.dumps(out)}")
    if not (loss_err <= CPU_AGREE and grad_err <= CPU_AGREE):
        raise AssertionError(f"17e {label}: the card's first step disagrees with the CPU's: {out}")
    return out


def trainer_steps(training, loss_fn, params, batch, lr: float, steps: int) -> dict:
    trainer = training.Trainer(loss_fn, training.make_optimizer(lr))
    state = trainer.init_state(params)
    step_s, losses = [], []
    for _ in range(steps):
        t1 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        losses.append(m["loss"].item())
    if not all(math.isfinite(x) for x in losses) or state.step != steps:
        raise AssertionError(f"trainer steps: losses {losses}, step {state.step}")
    return {"losses": losses, "step_ms": [1e3 * x for x in step_s]}


def phase17_controlnet_whisper(diffusion, whisper, layers, training, card: str) -> dict:
    """17e: ``flow_loss(control=)`` at ``controlnet.py``'s DiT config (f32,
    its zero-initialised leaves drawn nonzero, a batch of 16, null_prob 0 as
    it trains) and whisper-base (f32) fine-tuned as ``fine_tune_asr.py``
    does (the masked next-token loss over ``whisper.forward``, 2 x 30 s, 32
    tokens), each through ``Trainer`` for 2 steps on the card, the first
    step's loss and gradients held to the port's CPU run of the same inputs
    and weights within ``CPU_AGREE``."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    out = {}
    cfg = diffusion.DiTConfig(**CONTROLNET_CFG)
    params = diffusion.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(19)
    for t in tree_util.leaves(params):  # the zero-init leaves (modulation, projections) drawn nonzero
        if not t.any():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
    B, hw = CONTROLNET_B, cfg.img_size
    batch = {"images": torch.rand((B, hw, hw, 3), generator=gen) * 2 - 1,
             "control": (torch.rand((B, hw, hw, 3), generator=gen) > 0.7).float(),
             "text": torch.zeros((B, cfg.text_len, cfg.text_dim)),
             "t": torch.rand((B,), generator=gen), "eps": torch.randn((B, hw, hw, 3), generator=gen),
             "drop": torch.zeros((B,), dtype=torch.bool)}

    def dit_loss(p, b):
        return diffusion.flow_loss(p, b["images"], b["text"], cfg, control=b["control"], null_prob=0.0, t=b["t"],
                                   eps=b["eps"], drop=b["drop"])

    out["controlnet"] = card_vs_cpu_step(dit_loss, params, batch, "controlnet flow_loss")
    card_batch = {k: v.cuda() for k, v in batch.items()}
    out["controlnet"].update(trainer_steps(training, dit_loss, tree_util.map(lambda t: t.cuda(), params), card_batch,
                                           2e-3, FT_STEPS))
    wcfg = whisper.WhisperConfig.base()
    wparams = whisper.init_params(wcfg, seed=0, device="cpu")
    nb, frames, S = WHISPER_FT
    toks = torch.randint(0, wcfg.vocab_size, (nb, S), generator=gen)
    mask = torch.ones((nb, S))
    mask[1, S // 2:] = 0.0
    wbatch = {"mel": torch.randn((nb, frames, wcfg.n_mels), generator=gen), "tokens": toks, "mask": mask}

    def asr_loss(p, b):
        logits = whisper.forward(p, b["mel"], b["tokens"], wcfg)
        return training.cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    out["whisper"] = card_vs_cpu_step(asr_loss, wparams, wbatch, "whisper-base fine-tune")
    out["whisper"].update(trainer_steps(training, asr_loss, tree_util.map(lambda t: t.cuda(), wparams),
                                        {k: v.cuda() for k, v in wbatch.items()}, 3e-3, FT_STEPS))
    log(f"17e ControlNet and Whisper training ({card}): {json.dumps(out)}")
    return out


def phase_int4_and_training(fa, pa, qmm, errs: dict, int8_peak_gb: float, card: str) -> dict:
    """Phase 17: int4 weights on K7-int4 (17a the kernel, 17b serving, 17c
    QLoRA), DreamBooth-LoRA on the SD3-shape MMDiT (17d), ControlNet and
    Whisper training (17e). Returns its readings, its launches and
    K7-int4's kernels-line row."""
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams, training
    from modal_examples_tpu_torch.models import diffusion, layers, llama, lora, quantize, whisper
    from modal_examples_tpu_torch.ops import reference

    t0 = time.monotonic()
    out: dict = {"card": card}
    out["matmul"] = phase17_matmul(qmm, quantize, errs, card)
    free_fleet()
    out["serving"] = phase17_serving(fa, pa, qmm, llama, layers, reference, quantize, LLMEngine, OpenAIServer,
                                     SamplingParams, card)
    free_fleet()
    out["qlora"] = phase17_qlora(fa, qmm, llama, lora, training, quantize, int8_peak_gb, card)
    free_fleet()
    out["dreambooth"] = phase17_dreambooth(fa, diffusion, lora, training, reference, card)
    free_fleet()
    out["controlnet_whisper"] = phase17_controlnet_whisper(diffusion, whisper, layers, training, card)
    launches: dict = {}
    for part in ("serving", "qlora", "dreambooth"):
        for k, v in out[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for k in ("quantized_matmul_int4", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_decode", "kv_scatter"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"phase 17: {k} never launched: {launches}")
    out["launches"] = launches
    dec = out["matmul"]["decode"]
    out["row"] = dict(
        name="quantized_matmul_int4", route="cuda", source="modal_examples_tpu_torch/csrc/quantized_matmul_int4.cu",
        replaces="modal_examples_tpu/models/layers.py:100", launches=launches["quantized_matmul_int4"],
        max_abs_err=errs["quantized_matmul_int4"],
        **{k: dec[k] for k in ("ms", "ms_b2b", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "library_ms_b2b", "library_op", "bf16_mm_ms", "bf16_mm_ms_b2b", "shape")},
        replaces_note="no Pallas kernel: the JAX package's int4 product is XLA's dot over jnp.int4",
        prefill=out["matmul"]["prefill"],
    )
    out["seconds"] = time.monotonic() - t0
    log(f"phase 17 int4 weights and the training paths ({card}): ok in {out['seconds']:.1f}s; launches {launches}")
    return out


# -- phase 19: tensor and data parallelism over torch.distributed --------------------


#: 19b's Llama-2-7B depth for the int8 bursts and the bf16 write-then-attend
#: burst: cut from 32 to 8 for time (every collective of two ranks sharing
#: one card over gloo is a host round trip; listed in PERF.md §4); the
#: read-only bf16 burst and the logit check run all 32 layers
TP_CUT_LAYERS = 8
#: the dense path's depth (a cut) and its prompts x new tokens
TP_DENSE_LAYERS, TP_DENSE_SHAPE = 4, (4, 16)
#: 19b's logit check: 4 prompts of 96 tokens prefilled, then one decode step
TP_LOGIT_SHAPE = (4, 96)
#: 19d: B, H, S over two ranks, D
RING_SHAPE = (1, 32, 2 * 2048, 128)
#: the collectives 19b checks on CUDA tensors over gloo
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all", "broadcast_object_list")
#: 19c: the global batch (B = 1 a rank), the steps after the warm one
DP_BATCH, DP_STEPS = (2, 512), 2
DP_PADDED_LEN = 320  # 19c's second row: 320 of its 512 tokens counted


class AllToAllByGather:
    """``torch.distributed`` with ``all_to_all`` done by one ``all_gather``
    through host tensors: the phase's own stand-in for ``parallel.
    collectives``' ``dist`` (the port's collectives never stage on their
    own), installed where gloo refuses all_to_all (19b's probe; on the
    card's torch build gloo has no alltoall at all, CPU tensors neither).
    Every rank's sends are gathered and this rank's blocks taken."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_to_all(self, recv, send, group=None):
        me = self._dist.get_rank(group=group)
        flat = torch.cat([s.reshape(-1) for s in send]).cpu()
        parts = [torch.empty_like(flat) for _ in recv]
        self._dist.all_gather(parts, flat, group=group)
        start = sum(s.numel() for s in send[:me])
        for r, p in zip(recv, parts):
            r.copy_(p[start:start + r.numel()].view(r.shape))


class P2PThroughHost:
    """``torch.distributed`` with ``batch_isend_irecv`` done through host
    copies: the phase's own stand-in for ``parallel.collectives``' ``dist``
    in 19d (gloo's send and recv take CPU tensors only). Each op's tensor is
    copied to the host and exchanged; a received one is copied back."""

    def __init__(self, dist):
        self.inner = dist
        self.staged = 0  # exchanges staged

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def batch_isend_irecv(self, ops):
        host = [op.tensor.cpu() for op in ops]
        staged = [self.inner.P2POp(op.op, h, op.peer, op.group, op.tag) for op, h in zip(ops, host)]
        for work in self.inner.batch_isend_irecv(staged):
            work.wait()
        for op, h in zip(ops, host):
            if op.op is self.inner.irecv:
                op.tensor.copy_(h)
        self.staged += 1
        return []


def gloo_cuda_probe() -> dict:
    """Each collective the phase's paths call, once on CUDA tensors over the
    gloo group of every rank: "ok", or the error gloo raised (a finding)."""
    import torch.distributed as dist

    out = {}
    x = torch.ones(4, device="cuda")
    for op in GLOO_CUDA_OPS:
        try:
            if op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = y.sum().item() == 4 * dist.get_world_size()
            elif op == "broadcast":
                y = x.clone()
                dist.broadcast(y, src=0)
                ok = True
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
                dist.all_gather(parts, x)
                ok = all(p.sum().item() == 4 for p in parts)
            elif op == "all_to_all":
                send = list(torch.ones(dist.get_world_size(), 2, device="cuda").unbind(0))
                recv = [torch.empty_like(s) for s in send]
                dist.all_to_all(recv, send)
                ok = all(r.sum().item() == 2 for r in recv)
            else:
                box = [{"probe": 1} if dist.get_rank() == 0 else None]
                dist.broadcast_object_list(box, src=0)
                ok = box[0] == {"probe": 1}
            torch.cuda.synchronize()
            out[op] = "ok" if ok else "wrong result"
        except RuntimeError as e:  # a refusal on CUDA tensors is this probe's finding
            out[op] = f"refused: {str(e).splitlines()[0][:160]}"
    return out


def stage_refused(collectives, probe: dict) -> list:
    """All-to-all by gather where gloo refused it (``AllToAllByGather``, in
    this rank's ``parallel.collectives``); any other refusal fails the
    phase. Returns the ops staged."""
    import torch.distributed as dist

    other = {op: r for op, r in probe.items() if r != "ok" and op != "all_to_all"}
    if other:
        raise AssertionError(f"19b: gloo refused collectives the TP path needs on CUDA tensors: {other}")
    if probe["all_to_all"] == "ok":
        return []
    collectives.dist = AllToAllByGather(dist)
    return ["all_to_all"]


def kernel_counts(fa, pa, qmm) -> dict:
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches,
            "paged_decode": pa.decode_launches, "paged_decode_int8": pa.decode_int8_launches,
            "kv_scatter": pa.scatter_launches, "kv_scatter_int8": pa.scatter_int8_launches,
            "paged_decode_writeback": pa.decode_writeback_launches,
            "paged_decode_writeback_folded": pa.decode_writeback_fold_launches,
            "paged_decode_writeback_int8": pa.decode_writeback_int8_launches, "quantized_matmul": qmm.qmm_launches}


def zero_kernel_counts(fa, pa, qmm) -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    pa.decode_launches = pa.decode_int8_launches = pa.scatter_launches = pa.scatter_int8_launches = 0
    pa.decode_writeback_launches = pa.decode_writeback_fold_launches = pa.decode_writeback_int8_launches = 0
    qmm.qmm_launches = 0


def held_burst(eng, OpenAIServer, SamplingParams, hold: bool) -> tuple:
    """Phase 3's 8 requests as concurrent streamed ``/v1/completions``
    through an ``OpenAIServer`` on ``eng`` (with ``hold``: parked until all
    8 arrived, then queued shortest prompt first, as phase 3's direct burst
    queues them, so the engine finds them at one tick). Returns (the bodies,
    the streamed answers, the engine's requests in prompt order, /metrics,
    wall seconds)."""
    import concurrent.futures

    bodies = [{"prompt": p, "max_tokens": sp.max_tokens, "temperature": sp.temperature, "top_p": sp.top_p,
               "stream": True, "stream_options": {"include_usage": True},
               **({} if sp.seed is None else {"seed": sp.seed})} for p, sp in make_requests(SamplingParams)]
    recorded, lock = [], __import__("threading").Lock()
    submit = eng.submit_request

    def recording_submit(req):
        with lock:
            recorded.append(req)
            if hold and len(recorded) < len(bodies):
                return req  # parked
            batch = sorted(recorded, key=lambda r: len(r.prompt_tokens)) if hold else [req]
            for r in batch:
                submit(r)
        return req

    eng.submit_request = recording_submit
    server = OpenAIServer(eng, model_name="llama2-7b", port=0).start()
    base = f"http://{server.host}:{server.port}"
    try:
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            got = list(pool.map(lambda b: stream_completion(base, b), bodies))
        wall = time.monotonic() - t0
        settle(eng)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        check_pages_returned(eng, "19 burst")
    finally:
        eng.submit_request = submit
        server.stop()  # and the engine (a tensor-parallel engine's stop releases its followers)
    by_prompt = {r.prompt: r for r in recorded}
    reqs = [by_prompt[b["prompt"]] for b in bodies]
    for b, g, r in zip(bodies, got, reqs):
        check_finish(r)
        if (g["completion_tokens"], g["finish"]) != (r.n_generated, r.finish_reason):
            raise AssertionError(f"19: the streamed answer ({g}) is not the engine's request ({r.n_generated}, "
                                 f"{r.finish_reason})")
    return bodies, got, reqs, metrics, wall


def tp_engine_kw() -> dict:
    """Phase 3's engine settings."""
    return dict(max_slots=8, max_model_len=1024, prefill_buckets=(128, 256, 512), prefill_batch=4, decode_block=8,
                seed=0)


def tp19a(rank: int, rows_path: str) -> dict:
    """19a (one rank over NCCL): Llama-2-7B at full width and depth through
    ``LLMEngine(mesh=make_mesh({"tensor": 1}))`` and ``OpenAIServer``,
    phase 3's burst held as phase 3 queues it; its greedy and seeded rows
    must equal phase 3's tokens exactly; the model's collectives run on the
    one-wide NCCL group and are counted. Then the same held burst through
    the engine with no mesh, timed in the same process."""
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm
    from modal_examples_tpu_torch.parallel import collectives, make_mesh
    from modal_examples_tpu_torch.parallel.cluster import rank_backend

    mesh = make_mesh({"tensor": 1})
    cfg = llama.LlamaConfig.llama2_7b()
    eng = LLMEngine(cfg, mesh=mesh, device="cuda", **tp_engine_kw())
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))  # phase 3's warm-up
    zero_kernel_counts(fa, pa, qmm)
    collectives.counts.clear()
    _, got, reqs, metrics, wall = held_burst(eng, OpenAIServer, SamplingParams, hold=True)
    launches = kernel_counts(fa, pa, qmm)
    calls = dict(collectives.counts)
    rows = json.loads(Path(rows_path).read_text())
    held = equal = 0
    for r, (tokens, finish) in zip(reqs, rows):
        if r.params.temperature > 0 and r.params.seed is None:
            continue  # an engine-assigned seed: set at arrival
        held += 1
        equal += (list(r.generated_tokens), r.finish_reason) == (tokens, finish)
    if equal != held:
        raise AssertionError(f"19a: {held - equal} of {held} greedy and seeded rows differ from phase 3's tokens")
    if min(launches[k] for k in ("flash_fwd", "paged_decode", "kv_scatter")) <= 0 or not calls.get("psum"):
        raise AssertionError(f"19a: launches {launches}, collectives {calls}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the same held burst through the engine with no mesh, in this process:
    # what the one-wide group's collectives cost end to end
    one = LLMEngine(cfg, device="cuda", **tp_engine_kw())
    one.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    _, got_one, reqs_one, _, wall_one = held_burst(one, OpenAIServer, SamplingParams, hold=True)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    same = sum(list(a.generated_tokens) == list(b.generated_tokens) for a, b in zip(reqs, reqs_one))
    return {"backend": rank_backend(), "world": 1, "rows_held": held, "rows_equal": equal, "launches": launches,
            "collective_calls": calls, "burst_tok_per_s": sum(g["completion_tokens"] for g in got) / wall,
            "burst_tok_per_s_no_mesh": sum(g["completion_tokens"] for g in got_one) / wall_one,
            "rows_equal_to_no_mesh": same, "metrics_tp": 'tp="1"' in metrics}


def margin_rule(got, ref) -> dict:
    """The port's logit contract (cosine, max relative error) and greedy
    tokens by the top-2 margin rule: a row's argmax must agree wherever the
    reference's top-2 margin exceeds twice the largest logit error."""
    g, r = got.float().flatten(1), ref.float().flatten(1)
    cos = torch.nn.functional.cosine_similarity(g, r, dim=1).min().item()
    err = (g - r).abs().max().item()
    rel = err / r.abs().max().item()
    top2 = r.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1])
    clear = margin > 2 * err
    agree = (g.argmax(1) == r.argmax(1))
    return {"cosine_min": cos, "max_rel_err": rel, "max_abs_err": err, "rows_clear": int(clear.sum()),
            "rows_clear_agreeing": int((agree & clear).sum()), "rows_agreeing": int(agree.sum()),
            "ok": cos > CONTRACT["cosine_min"] and rel < CONTRACT["max_rel_err"] and bool((agree | ~clear).all())}


def tp_logits(llama, cfg, params, mesh, tokens, tables, lens) -> tuple:
    """Prefill ``tokens``, then one decode step of each row's greedy token:
    both logits (bf16 pages, one layer's cache for this rank's heads)."""
    from modal_examples_tpu_torch.ops.sharded import mesh_tp_degree
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    tp = mesh_tp_degree(mesh)
    c = PagedKVCache.create(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads // tp, head_dim=cfg.head_dim,
                            n_pages=1 + tables.numel(), page_size=16, kv_dtype="bfloat16", device="cuda")
    with torch.no_grad():
        pre, kp, vp = llama.prefill(params, tokens, c.k_pages, c.v_pages, tables, lens, cfg, mesh=mesh)
        nxt = pre.argmax(-1).int()
        dec, _, _ = llama.decode_step(params, nxt, lens, kp, vp, tables, torch.ones_like(lens, dtype=torch.bool), cfg,
                                      mesh=mesh)
    return pre, dec


def tp_logit_inputs(cfg):
    B, S = TP_LOGIT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(19)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    pps = (S + 1 + 15) // 16
    tables = (1 + torch.arange(B * pps, device="cuda", dtype=torch.int32)).reshape(B, pps)
    lens = torch.tensor([S, S - 17, S - 40, 33][:B], dtype=torch.int32, device="cuda")
    return tokens, tables, lens


def tp19_reference(llama, path: Path) -> None:
    """The one-card port's prefill and decode logits on phase 3's weights,
    for 19b (computed here, before the ranks start)."""
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    pre, dec = tp_logits(llama, cfg, params, None, *tp_logit_inputs(cfg))
    torch.save({"prefill": pre.cpu(), "decode": dec.cpu()}, path)
    del params


def local_kernels(fa, pa, qmm, gen) -> dict:
    """Each kernel of the TP path against its plain version at one rank's
    shapes at TP=2 (16 of 32 heads): K1, K2, K3, K4 with the folded write,
    K7 column- and row-parallel."""
    out = {}
    q, k, v = flash_case(gen, 4, 16, 16, 512, 512)
    o, _ = fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=128**-0.5)
    want, _ = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=128**-0.5)
    out["flash_fwd"] = max_err(o, want)
    c = decode_case(gen, 8, 16, 16, L=4)
    out["paged_decode"] = check_decode("paged_decode", pa.paged_decode_cuda, pa.paged_decode_plain, c,
                                       "19b K2 at 16 kv heads")
    L, N, P = 32, 8, 513
    k_all, v_all, page_idx, slot = scatter_case(gen, L, N, P, Hkv=16)
    kp, vp = rand_bf16(gen, L, P, 16, 16, 128), rand_bf16(gen, L, P, 16, 16, 128)
    kq, vq = kp.clone(), vp.clone()
    pa.scatter_cuda(kp, vp, k_all, v_all, page_idx, slot)
    pa.scatter_plain(kq, vq, k_all, v_all, page_idx.long(), slot.long())
    out["kv_scatter"] = max(max_err(kp, kq), max_err(vp, vq))
    B, ctx = 8, [1, 16, 17, 1001, 334, 512, 700, 1]
    c = writeback_case(gen, B, 16, 16, L=4, ctx=ctx, dead=True)
    pos = (c["context_lens"] - 1).long()
    page = c["page_tables"].gather(1, (pos // 16)[:, None])[:, 0]
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    live[-1] = False
    fold = dict(k_new=rand_bf16(gen, B, 16, 128), v_new=rand_bf16(gen, B, 16, 128),
                page_idx=torch.where(live, page, 0).int(), slot=torch.where(live, pos % 16, 0).int())
    kp, vp = c["k_pages"].clone(), c["v_pages"].clone()
    o = pa.paged_decode_writeback_cuda(c["q"], kp, vp, c["page_tables"], c["context_lens"], sm_scale=128**-0.5,
                                       **fold)
    kq, vq = c["k_pages"].clone(), c["v_pages"].clone()
    want = pa.paged_decode_writeback_plain(c["q"], kq, vq, c["page_tables"], c["context_lens"], sm_scale=128**-0.5,
                                           **fold)
    if not (torch.equal(kp, kq) and torch.equal(vp, vq)):
        raise AssertionError("19b: the folded write's pages differ from its plain version's at 16 kv heads")
    out["paged_decode_writeback_folded"] = rel_err(o, want)
    for K, Nn in ((4096, 2048), (2048, 4096)):
        w = torch.randn(K, Nn, generator=gen, device="cuda")
        wq, ws = qmm.quantize_int8(w)
        for M in (8, 512):
            x = rand_bf16(gen, M, K)
            out[f"quantized_matmul {M}x{K}x{Nn}"] = rel_err(qmm.qmm_cuda(x, wq, ws), qmm.qmm_plain(x, wq, ws))
    torch.cuda.synchronize()
    limits = {"flash_fwd": TOL["flash_fwd"], "paged_decode": TOL["paged_decode"], "kv_scatter": 0.0,
              "paged_decode_writeback_folded": TOL["paged_decode_writeback"]}
    for name, e in out.items():
        lim = limits.get(name, TOL["quantized_matmul"])
        if not e <= lim:
            raise AssertionError(f"19b: {name} at the per-shard shape disagrees with its plain version: {e} > {lim}")
    return out


def tp_serve(m, cfg, mesh, rank: int, label: str, **kw) -> dict:
    """One 8-request burst through rank 0's TP engine and server (rank 1
    follows): finish reasons, token counts, pages returned, ``tp="2"`` on
    /metrics. The kernels launched: rank 0's burst, and the follower's whole
    run with its warm-up's (rank 0's ``warm_up`` counts) to subtract."""
    fa, pa, qmm = m["fa"], m["pa"], m["qmm"]
    zero_kernel_counts(fa, pa, qmm)
    if rank:
        m["follow"](cfg, mesh=mesh, device="cuda")
        return {"launches": kernel_counts(fa, pa, qmm)}
    eng = m["LLMEngine"](cfg, mesh=mesh, device="cuda", **tp_engine_kw(), **kw)
    try:
        eng.generate("warm up", m["SamplingParams"](max_tokens=2, temperature=0.0))
        settle(eng)
        warm = kernel_counts(fa, pa, qmm)
        zero_kernel_counts(fa, pa, qmm)
        _, got, reqs, metrics, wall = held_burst(eng, m["OpenAIServer"], m["SamplingParams"], hold=True)
        launches = kernel_counts(fa, pa, qmm)
        plan = dict(eng.impl_plan)
    finally:
        eng.stop()  # releases the follower (a no-op once the server stopped it)
    if 'tp="2"' not in metrics:
        raise AssertionError(f"19b {label}: /metrics does not carry tp=\"2\"")
    out = {"launches": launches, "warm_up": warm, "plan": plan, "wall_s": wall,
           "tok_per_s_two_ranks_sharing_one_card_over_gloo": sum(g["completion_tokens"] for g in got) / wall,
           "finish": [r.finish_reason for r in reqs], "tokens": [len(r.generated_tokens) for r in reqs]}
    log(f"19b {label}: {json.dumps(out)}")
    return out


def dense_logits(tensor_parallel, params, cfg, tokens, mesh):
    """``decode_step_dense``'s logits [B, T - 1, V] with ``tokens`` [B, T]
    fed one position at a time (the dense cache; ``mesh``: this rank's
    shards)."""
    if mesh is not None:
        params = tensor_parallel.shard_params_tp(params, cfg, mesh)
    B, T = tokens.shape
    cache = tensor_parallel.DenseKVCache.create(cfg, B, T, mesh, dtype=params["embed"].dtype, device="cuda")
    out = []
    with torch.no_grad():
        for pos in range(T - 1):
            positions = torch.full((B,), pos, dtype=torch.int32, device="cuda")
            logits, cache = tensor_parallel.decode_step_dense(params, tokens[:, pos], cache, positions, cfg, mesh=mesh)
            out.append(logits.float())
    return torch.stack(out, dim=1)


def tp19b(rank: int, ref_path: str) -> dict:
    """19b (two ranks in two processes sharing the one card, gloo over CUDA
    tensors): the collectives probed, the logits against the one-card port,
    the kernels at the per-shard shapes, four bursts through rank 0's
    server, the dense path at a cut depth."""
    import torch.distributed as dist

    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm
    from modal_examples_tpu_torch.parallel import collectives, make_mesh
    from modal_examples_tpu_torch.serving import tensor_parallel
    from modal_examples_tpu_torch.serving.engine import follow

    t0 = time.monotonic()
    probe = gloo_cuda_probe()
    staged = stage_refused(collectives, probe)
    mesh = make_mesh({"tensor": 2})
    cfg = llama.LlamaConfig.llama2_7b()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "gloo_cuda": probe,
           "staged_through_host": staged}
    params = llama.init_params(cfg, seed=0, device="cuda", map_layer=lambda layer: llama.shard_layer(layer, cfg, mesh))
    params = llama.shard_params(params, cfg, mesh, layers=False)
    out["rank_weights_gb"] = sum(t.numel() * t.element_size() for t in
                                 [params["embed"], params["lm_head"], *(w for l in params["layers"]
                                                                         for w in l.values())]) / 1e9
    pre, dec = tp_logits(llama, cfg, params, mesh, *tp_logit_inputs(cfg))
    ref = torch.load(ref_path)
    out["logits"] = {"prefill": margin_rule(pre.cpu(), ref["prefill"]), "decode": margin_rule(dec.cpu(), ref["decode"])}
    if not all(v["ok"] for v in out["logits"].values()):
        raise AssertionError(f"19b: TP=2 logits outside the contract: {out['logits']}")
    del params, pre, dec
    gc.collect()
    torch.cuda.empty_cache()
    out["kernels_at_local_shapes"] = local_kernels(fa, pa, qmm, torch.Generator(device="cuda").manual_seed(rank))
    m = dict(fa=fa, pa=pa, qmm=qmm, LLMEngine=LLMEngine, OpenAIServer=OpenAIServer, SamplingParams=SamplingParams,
             follow=follow)
    cut = dataclasses.replace(cfg, n_layers=TP_CUT_LAYERS)
    out["bursts"] = {}
    for label, kw, c in (("read-only bf16", {}, cfg), ("write-then-attend bf16", {"paged_impl": "pallas-writeback"}, cut),
                         ("int8 weights and pages", {"quantization": "int8", "kv_dtype": "int8"}, cut),
                         ("int8 write-then-attend", {"quantization": "int8", "kv_dtype": "int8",
                                                     "paged_impl": "pallas-writeback"}, cut)):
        out["bursts"][label] = tp_serve(m, c, mesh, rank, label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    dense_cfg = dataclasses.replace(cfg, n_layers=TP_DENSE_LAYERS)
    full = llama.init_params(dense_cfg, seed=0, device="cuda")
    B, n_new = TP_DENSE_SHAPE
    prompts = torch.randint(0, cfg.vocab_size, (B, 8), generator=torch.Generator(device="cuda").manual_seed(3),
                            device="cuda", dtype=torch.int32)
    lens = torch.tensor([8, 5, 7, 3], dtype=torch.int32, device="cuda")
    t1 = time.monotonic()
    toks = tensor_parallel.generate_tp(full, dense_cfg, prompts, lens, n_new, mesh=mesh, max_len=64)
    torch.cuda.synchronize()
    one = tensor_parallel.generate_tp(full, dense_cfg, prompts, lens, n_new, max_len=64)
    # decode_step_dense's logits at every position of the TP=2 run's tokens,
    # at TP=2 and on one rank, held by the port's logit contract
    logits = [dense_logits(tensor_parallel, full, dense_cfg, toks, m) for m in (mesh, None)]
    out["dense"] = {"layers": TP_DENSE_LAYERS, "shape": [B, n_new], "s": time.monotonic() - t1,
                    "tokens_equal_to_one_rank": int((toks == one).all(dim=1).sum()),
                    "logits": margin_rule(*(x.reshape(-1, x.shape[-1]).cpu() for x in logits))}
    if not out["dense"]["logits"]["ok"]:
        raise AssertionError(f"19b dense path: TP=2 logits outside the contract: {out['dense']}")
    del full
    gc.collect()
    torch.cuda.empty_cache()
    out["collective_calls"] = dict(collectives.counts)
    out["seconds"] = time.monotonic() - t0
    return out


def dp19c(rank: int) -> dict:
    """19c: data-parallel LoRA over the two ranks (gloo over CUDA tensors):
    Llama-2-7B's bf16 base on each, rank-16 adapters on the seven
    projections, each rank's B=1 x S=512 row of a B=2 batch whose second
    row is padded (the ranks count different tokens, and the loss is the
    mean over the global batch's tokens). The gradients summed over the
    ranks (``Trainer.loss_and_grads``) against one rank's B=2 gradients on
    the same data (cosine per target); then 1 + 2 ``Trainer`` steps."""
    from modal_examples_tpu_torch import training
    from modal_examples_tpu_torch.models import llama, lora
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": 2})
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    lcfg = lora.LoRAConfig(rank=16)
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), params, lcfg)
    B, S = DP_BATCH
    gen = torch.Generator(device="cuda").manual_seed(1)
    lens = torch.tensor([S, DP_PADDED_LEN], device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]).float()
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda"), "mask": mask}
               for _ in range(1 + DP_STEPS)]

    def loss_fn(ad, batch):
        logits = llama.forward(params, batch["tokens"], cfg, attn_impl="flash", lora=ad, lora_scale=lcfg.scale)
        return training.cross_entropy_terms(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4), mesh=mesh)
    _, grads = trainer.loss_and_grads(adapters, batches[0])
    out = {}
    if rank == 0:
        _, ref = training.Trainer(loss_fn, training.make_optimizer(1e-4)).loss_and_grads(adapters, batches[0])
        out["grad_check"] = compare_adapter_grads(grads["layers"], ref["layers"], lcfg.targets,
                                                  "19c sum over ranks of B=1 a rank vs one rank's B=2")
        del ref
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    state = trainer.init_state(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    step_s, losses = [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
    out.update(launches={"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches},
               step_ms=[1e3 * s for s in step_s], losses=losses, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = cfg.n_layers * len(batches)
    if out["launches"] != {k: want for k in out["launches"]} or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"19c rank {rank}: {out}")
    del params, state, adapters
    gc.collect()
    torch.cuda.empty_cache()
    return out


def exact_attention_grads(q, k, v, do, causal: bool, heads_per_chunk: int = 8) -> list:
    """dQ, dK, dV of ``sum(o * do)`` for plain attention in f32 over the
    whole sequence (no TF32): the exact gradient that 19d holds the bf16
    kernels' gradients to. Computed a few heads at a time."""
    S, Skv = q.shape[2], k.shape[2]
    grads = [torch.empty(t.shape, dtype=torch.float32, device=t.device) for t in (q, k, v)]
    mask = torch.ones(S, Skv, dtype=torch.bool, device=q.device).triu(1) if causal else None
    for h in range(0, q.shape[1], heads_per_chunk):
        heads = slice(h, h + heads_per_chunk)
        qf, kf, vf = (t[:, heads].float().requires_grad_(True) for t in (q, k, v))
        s = (qf @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if mask is not None:
            s = s.masked_fill(mask, float("-inf"))
        (torch.softmax(s, dim=-1) @ vf).backward(do[:, heads].float())
        for g, t in zip(grads, (qf, kf, vf)):
            g[:, heads] = t.grad
        del s, qf, kf, vf
    return grads


def ring19d(rank: int) -> dict:
    """19d: ring and Ulysses attention over the two ranks (S = 2 x 2048, H
    32, D 128, causal and full) against K1 over the whole sequence on one
    rank. The ring's gradients (K5, K6 at each hop) and K5/K6's over the
    whole sequence are each held against the exact f32 gradient at K5/K6's
    tolerance; the ring against the whole-sequence backward is reported."""
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import ring_attention as ra
    from modal_examples_tpu_torch.parallel import collectives, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # the exact gradient in full f32
    # gloo's send and recv refuse CUDA tensors ("Bad address" on the card):
    # the ring's hops go through host copies, done here, not by the port
    p2p = collectives.dist = P2PThroughHost(collectives.dist)
    mesh = make_mesh({"seq": 2})
    B, H, S, D = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = flash_case(gen, B, H, H, S, S, D)
    do = rand_bf16(gen, B, H, S, D)
    out, launches = {}, {}
    tol = {"q": TOL["flash_bwd_dq"], "k": TOL["flash_bwd_dkv"], "v": TOL["flash_bwd_dkv"]}
    for causal in (True, False):
        # the whole sequence on this rank: the reference (its launches not counted)
        want = fa.flash_attention(q, k, v, causal)
        full = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        (fa.flash_attention(*full, causal).float() * do.float()).sum().backward()
        exact = exact_attention_grads(q, k, v, do, causal)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        ring = ra.ring_attention_sharded(q, k, v, mesh, causal=causal)
        uly = ra.ulysses_attention_sharded(q, k, v, mesh, causal=causal)
        blocks = [t.chunk(2, dim=2)[rank].contiguous().requires_grad_(True) for t in (q, k, v)]
        o = ra.ring_attention(*blocks, axis_name="seq", causal=causal, mesh=mesh)
        (o.float() * do.chunk(2, dim=2)[rank].float()).sum().backward()
        torch.cuda.synchronize()
        for name, n in (("flash_fwd", fa.launches), ("flash_bwd_dq", fa.dq_launches),
                        ("flash_bwd_dkv", fa.dkv_launches)):
            launches[name] = launches.get(name, 0) + n
        mine = [e.chunk(2, dim=2)[rank] for e in exact]
        key = "causal" if causal else "full"
        out[key] = {"ring_rel_err": rel_err(ring, want), "ulysses_rel_err": rel_err(uly, want),
                    "ring_grad_vs_exact": {n: rel_err(b.grad, e) for n, b, e in zip("qkv", blocks, mine)},
                    "whole_grad_vs_exact": {n: rel_err(f.grad, e) for n, f, e in zip("qkv", full, exact)},
                    "ring_grad_vs_whole": {n: rel_err(b.grad, f.grad.chunk(2, dim=2)[rank])
                                           for n, b, f in zip("qkv", blocks, full)}}
        held = all(out[key][g][n] <= tol[n] for g in ("ring_grad_vs_exact", "whole_grad_vs_exact") for n in tol)
        if not (out[key]["ring_rel_err"] <= TOL["flash_fwd"] and out[key]["ulysses_rel_err"] <= TOL["flash_fwd"]
                and held):
            raise AssertionError(f"19d {key}: {out[key]}")
        del exact, mine, full, blocks
    out["launches"] = launches
    out["ppermute_staged_through_host"] = p2p.staged
    collectives.dist = p2p.inner
    return out


APP_CLUSTERED = '''
"""chip_smoke.py phase 19e: @clustered(size=1) on the card."""
import torch

import modal_examples_tpu_torch as mtpu

app = mtpu.App("smoke-clustered")


@app.function(gpu="H100", timeout=600)
@mtpu.experimental.clustered(size=1)
def one_rank_k1() -> dict:
    import torch.distributed as dist

    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.parallel import cluster, collectives, make_mesh

    info = cluster.get_cluster_info()
    device = cluster.init_distributed()
    mesh = make_mesh({"data": 1})
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(4, 32, 512, 128, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    o, _ = fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=128**-0.5)
    want, _ = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=128**-0.5)
    total = collectives.psum(torch.ones(1, device="cuda"), "data", mesh).item()
    return {"rank": info.rank, "size": info.size, "backend": dist.get_backend(), "world": dist.get_world_size(),
            "device": str(device), "card": torch.cuda.get_device_name(0), "k1_launches": fa.launches,
            "max_abs_err": (o.float() - want.float()).abs().max().item(), "psum": total}
'''


def phase19_clustered(card: str) -> dict:
    from modal_examples_tpu_torch.core.app import load_module_from_path

    tmp = ROOT / "build" / "smoke-apps-19"
    tmp.mkdir(parents=True, exist_ok=True)
    mod = load_module_from_path(str(write_app(tmp, "smoke_clustered", APP_CLUSTERED)))
    with mod.app.run():
        r = mod.one_rank_k1.remote()
    shutil.rmtree(tmp, ignore_errors=True)
    if not (r["backend"] == "nccl" and r["world"] == 1 and r["k1_launches"] == 1 and r["psum"] == 1.0
            and r["max_abs_err"] <= TOL["flash_fwd"]):
        raise AssertionError(f"19e: {r}")
    log(f"19e @clustered(size=1) ({card}): {json.dumps(r)}")
    return r


# -- 19f: tensor-parallel and FSDP training through Trainer(param_specs=) ----------------


#: 19f's global batches: (i) TP and (ii) FSDP B=2 x S=512 (under FSDP one
#: row a rank), (iii) B=1 x S=512; one warm step, then TRAIN19F_STEPS timed
TRAIN19F_BATCH, TRAIN19F_MOE_BATCH, TRAIN19F_STEPS = (2, 512), (1, 512), 2
#: (iii)'s Mixtral-8x7B depth: cut from 32 to 2 for memory and time (the
#: one-rank reference holds every expert's bf16 stack and its gradient;
#: PERF.md §4). Its widths are the model's.
TRAIN19F_MOE_LAYERS = 2
TRAIN19F_LR = 1e-4
#: the first step's loss against the one-rank trainer's (relative), and
#: (ii)'s at-rest bytes of parameters and moments a rank against its
FSDP_BYTES_MAX, TRAIN19F_LOSS_RTOL = 0.55, 1e-2
FLASH_WRAPPERS = ("flash_forward_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda")


def train19f_cases(llama) -> dict:
    """19f's cases: name -> (config, mesh axes, global batch shape, capacity
    experts). (i) and (ii) train Llama-3.2-1B (bf16, tied head) at full
    width and depth; (iii) Mixtral-8x7B's widths at TRAIN19F_MOE_LAYERS."""
    dense = llama.LlamaConfig.llama32_1b()
    moe = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(), n_layers=TRAIN19F_MOE_LAYERS)
    return {"tp": (dense, {"tensor": 2}, TRAIN19F_BATCH, False),
            "fsdp": (dense, {"fsdp": 2}, TRAIN19F_BATCH, False),
            "tp_moe": (moe, {"tensor": 2}, TRAIN19F_MOE_BATCH, True)}


def train19f_reference_key(case: str) -> str:
    """(i) and (ii) share one reference: the same model and batch."""
    return "moe" if case == "tp_moe" else "dense"


def train19f_batch(cfg, shape) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(27)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen, device="cuda")}


def train19f_loss(llama, training, cfg, capacity: bool):
    """The loss of 19f's cases, as a user writes it: ``llama.forward`` with
    no mesh (the trainer enters its own), the flash kernels, and on the
    capacity experts the load-balance loss at phase 18's weight."""
    def loss_fn(p, batch):
        tokens = batch["tokens"]
        if capacity:
            logits, aux = llama.forward(p, tokens, cfg, attn_impl="flash", moe_impl="capacity", return_aux=True)
            return training.cross_entropy_loss(logits[:, :-1], tokens[:, 1:]) + MOE_AUX_WEIGHT * aux
        return training.cross_entropy_loss(llama.forward(p, tokens, cfg, attn_impl="flash")[:, :-1], tokens[:, 1:])
    return loss_fn


def named_leaves(tree_, path: tuple = ()) -> dict:
    """A parameter tree's (or a placement tree's) leaves by dotted path."""
    from modal_examples_tpu_torch.parallel.mesh import P

    if isinstance(tree_, dict):
        return {k: v for key, sub in tree_.items() for k, v in named_leaves(sub, path + (str(key),)).items()}
    if isinstance(tree_, (list, tuple)) and not isinstance(tree_, P):
        return {k: v for i, sub in enumerate(tree_) for k, v in named_leaves(sub, path + (str(i),)).items()}
    return {".".join(path): tree_}


def tree_bytes(tree_) -> int:
    return sum(t.numel() * t.element_size() for t in named_leaves(tree_).values())


def state_bytes(state) -> int:
    """At-rest bytes of a ``TrainState``: parameters and both Adam moments."""
    return tree_bytes(state.params) + tree_bytes(state.opt_state["mu"]) + tree_bytes(state.opt_state["nu"])


def train19f_reference(llama, training, work: Path) -> dict:
    """19f's references, in this process before the ranks start: the port's
    one-rank ``Trainer`` over each model's whole batch (from the same seed
    as the ranks'), its first loss and at-rest bytes; the gradients and the
    capacity experts' top-k choices are written under ``work`` for the
    ranks, and everything is freed."""
    from modal_examples_tpu_torch.models import moe

    out = {}
    for case in ("tp", "tp_moe"):
        cfg, _, shape, capacity = train19f_cases(llama)[case]
        t0 = time.monotonic()
        params = llama.init_params(cfg, seed=0, device="cuda")
        trainer = training.Trainer(train19f_loss(llama, training, cfg, capacity),
                                   training.make_optimizer(TRAIN19F_LR))
        routes = RouteReplay(moe)
        with routes.recording():
            loss, grads = trainer.loss_and_grads(params, train19f_batch(cfg, shape))
        key = train19f_reference_key(case)
        path = work / f"19f_{key}_grads.pt"
        torch.save({k: g.cpu() for k, g in named_leaves(grads).items()}, path)
        torch.save([c.cpu() for c in routes.choices], work / f"19f_{key}_routes.pt")
        del grads
        state = trainer.init_state(params)
        out[key] = {"loss": loss.item(), "bytes": state_bytes(state), "grads": str(path),
                    "routes": str(work / f"19f_{key}_routes.pt"), "s": time.monotonic() - t0}
        del params, state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


class launch_shapes:
    """Records (wrapper, q shape, k shape) of every K1, K5 and K6 launch in
    its block (the flash wrappers wrapped in ``ops.flash_attention``, where
    the autograd function finds them)."""

    def __init__(self, fa):
        self.fa, self.shapes = fa, set()

    def __enter__(self):
        self.kept = {name: getattr(self.fa, name) for name in FLASH_WRAPPERS}
        for name, fn in self.kept.items():
            setattr(self.fa, name, self._recording(name, fn))
        return self

    def _recording(self, name, fn):
        def launch(q, k, *args, **kw):
            self.shapes.add((name, tuple(q.shape), tuple(k.shape)))
            return fn(q, k, *args, **kw)
        return launch

    def __exit__(self, *exc):
        for name, fn in self.kept.items():
            setattr(self.fa, name, fn)


def flash_counts(fa) -> tuple:
    return fa.launches, fa.dq_launches, fa.dkv_launches


def flash_at_shape(fa, gen, B: int, Hq: int, Hkv: int, S: int, D: int) -> dict:
    """K1, K5 and K6 against their plain versions at one causal shape, at
    phase 2's limits (K1 max|o - plain|; K5 and K6 relative to the largest
    plain gradient). Raises if one disagrees."""
    q, k, v = flash_case(gen, B, Hq, Hkv, S, S, D)
    o, _ = fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=D**-0.5)
    want, _ = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5)
    out = {"shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D}, "flash_fwd": max_err(o, want)}
    args, o = bwd_case(fa, gen, B, Hq, Hkv, S, True, False, D)
    dq = fa.flash_bwd_dq_cuda(*args, causal=True, sm_scale=D**-0.5)
    dk, dv = fa.flash_bwd_dkv_cuda(*args, causal=True, sm_scale=D**-0.5)
    q, k, v, do, lse, _, dlse = args
    wq, wk, wv = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal=True, sm_scale=D**-0.5)
    torch.cuda.synchronize()
    out.update(flash_bwd_dq=rel_err(dq, wq), flash_bwd_dkv=max(rel_err(dk, wk), rel_err(dv, wv)))
    if not all(out[name] <= TOL[name] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        raise AssertionError(f"19f: the flash kernels disagree with their plain versions at {out['shape']}: {out}")
    return out


def train19f_case(rank: int, case: str, ref: dict) -> dict:
    """One of 19f's cases on this rank: the model from seed 0, placed by
    ``Trainer(param_specs=)`` (``llama.partition_specs`` on a ``tensor``
    axis, ``fsdp_specs`` on an ``fsdp`` axis with the batch split over it),
    the whole tree then freed; the first gradients' cosine parts against
    the one-rank trainer's (``ref``, written by the parent), the replicated
    leaves' digests; one warm step and TRAIN19F_STEPS timed, with each
    step's K1/K5/K6 launches and collectives; then the three kernels
    against their plain versions at the shapes the steps launched."""
    import hashlib

    from modal_examples_tpu_torch import training
    from modal_examples_tpu_torch.models import llama, moe
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.parallel import collectives, make_mesh
    from modal_examples_tpu_torch.parallel.mesh import P, fsdp_specs, shard_tensor, specs_for

    cfg, axes, shape, capacity = train19f_cases(llama)[case]
    mesh = make_mesh(axes)
    fsdp = "fsdp" in axes
    params = llama.init_params(cfg, seed=0, device="cuda")
    specs = fsdp_specs(params, mesh) if fsdp else llama.partition_specs(cfg)
    trainer = training.Trainer(train19f_loss(llama, training, cfg, capacity), training.make_optimizer(TRAIN19F_LR),
                               mesh=mesh, param_specs=specs, batch_spec=P("fsdp") if fsdp else P())
    state = trainer.init_state(params)
    placement = named_leaves(specs_for(params, specs))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    batch = train19f_batch(cfg, shape)
    out = {"at_rest_bytes": state_bytes(state), "one_rank_bytes": ref["bytes"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = flash_counts(fa)
    per_step, colls, step_ms, losses = [], [], [], []
    routes = RouteReplay(moe)
    routes.choices = [c.to("cuda") for c in torch.load(ref["routes"])]
    with launch_shapes(fa) as seen:
        # the first gradients on the reference's expert choices (a free
        # run's bf16 sums in another order flip near-ties: RouteReplay)
        with routes.replaying():
            loss0, grads = trainer.loss_and_grads(state.params, batch)
        # each leaf's block against the one-rank gradient's block: the parts
        # of the whole leaf's cosine (dot, |g|^2, |ref|^2), summed over the
        # ranks by the caller where the leaf is placed
        refs = torch.load(ref["grads"], mmap=True, map_location="cpu")
        parts, replicated = {}, {}
        for name, g in named_leaves(grads).items():
            want = shard_tensor(refs[name], placement[name], mesh).to("cuda").float()
            a = g.float()
            parts[name] = [(a * want).sum().item(), (a * a).sum().item(), (want * want).sum().item()]
            if not any(placement[name]):
                replicated[name] = hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()
        del grads, refs
        for i in range(1 + TRAIN19F_STEPS):
            before, calls = flash_counts(fa), dict(collectives.counts)
            t0 = time.monotonic()
            # the warm step routes freely from the reference's parameters:
            # its tokens whose choices differ from the reference's counted
            with routes.comparing() if i == 0 else contextlib.nullcontext():
                state, m = trainer.train_step(state, batch)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.monotonic() - t0))
            per_step.append([a - b for a, b in zip(flash_counts(fa), before)])
            colls.append({op: n - calls.get(op, 0) for op, n in collectives.counts.items() if n != calls.get(op, 0)})
    total = [a - b for a, b in zip(flash_counts(fa), start)]
    out.update(loss0=loss0.item(), ref_loss=ref["loss"], losses=losses, step_ms=step_ms, route_flips=routes.flips,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, grad_parts=parts, replicated=replicated,
               placed_axes={name: sorted({a for a in spec if a is not None}) for name, spec in placement.items()},
               launches=dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), total)),
               launches_per_step=per_step, collectives_per_step=colls, launch_shapes=sorted(seen.shapes))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels against their plain versions at the shapes the steps launched
    tp = 2 if "tensor" in axes else 1
    B, S = shape[0] // (2 if fsdp else 1), shape[1]
    Hq, Hkv, D = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    want_shapes = sorted((name, (B, Hq, S, D), (B, Hkv, S, D)) for name in FLASH_WRAPPERS)
    out["kernels_at_shape"] = flash_at_shape(fa, torch.Generator(device="cuda").manual_seed(19 + rank), B, Hq, Hkv, S, D)
    out["launch_shapes_expected"] = want_shapes
    return out


def check19f(llama, ranks: list) -> dict:
    """19f's results of both ranks, held: each leaf's gradient (its blocks'
    cosine parts summed over the ranks where it is placed) at cosine >=
    GRAD_COSINE_MIN against the one-rank trainer's, the first loss within
    TRAIN19F_LOSS_RTOL, replicated leaves' gradients bitwise equal on both
    ranks, FSDP's at-rest bytes <= FSDP_BYTES_MAX of one rank's, and each
    step's K1, K5 and K6 launches: one a layer, at the expected shapes.
    Returns each case's summary (rank 0's step figures, both ranks' peaks);
    raises after every case is summarised."""
    out, failed = {}, {}
    for case, (cfg, axes, shape, _) in train19f_cases(llama).items():
        r0, r1 = (r[case] for r in ranks)
        cos = {}
        for name, (dot, aa, bb) in r0["grad_parts"].items():
            if r0["placed_axes"][name]:
                dot, aa, bb = (x + y for x, y in zip((dot, aa, bb), r1["grad_parts"][name]))
            cos[name] = dot / max(math.sqrt(aa * bb), 1e-30)
        worst = min(cos, key=cos.get)
        per_step = [[cfg.n_layers] * 3] * (1 + TRAIN19F_STEPS)
        summary = {
            "config": {"dim": cfg.dim, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "vocab": cfg.vocab_size, "experts": cfg.n_experts, "mesh": axes, "batch": list(shape)},
            "grad_cosine_min": cos[worst], "grad_cosine_worst_leaf": worst, "leaves": len(cos),
            "loss0": [r0["loss0"], r1["loss0"]], "one_rank_loss0": r0["ref_loss"], "losses": r0["losses"],
            "route_flips_free_warm_step": [r0["route_flips"], r1["route_flips"]],
            "replicated_bitwise": sorted(r0["replicated"]), "step_ms": [r0["step_ms"], r1["step_ms"]],
            "peak_gb": [r0["peak_gb"], r1["peak_gb"]], "at_rest_bytes": [r0["at_rest_bytes"], r1["at_rest_bytes"]],
            "one_rank_bytes": r0["one_rank_bytes"],
            "at_rest_ratio": max(r0["at_rest_bytes"], r1["at_rest_bytes"]) / r0["one_rank_bytes"],
            "launches_per_step": r0["launches_per_step"], "collectives_per_step": r0["collectives_per_step"][-1],
            "launch_shapes": r0["launch_shapes"], "kernels_at_shape": [r0["kernels_at_shape"], r1["kernels_at_shape"]],
        }
        out[case] = summary
        faults = []
        if cos[worst] < GRAD_COSINE_MIN:
            faults.append(f"gradient cosine {cos[worst]} at {worst}")
        if not all(abs(r["loss0"] - r0["ref_loss"]) <= TRAIN19F_LOSS_RTOL * abs(r0["ref_loss"]) for r in (r0, r1)):
            faults.append("first loss")
        if r0["replicated"] != r1["replicated"] or not r0["replicated"]:
            faults.append("replicated gradients differ across the ranks")
        if "fsdp" in axes and summary["at_rest_ratio"] > FSDP_BYTES_MAX:
            faults.append("at-rest bytes")
        for r in (r0, r1):
            if r["launches_per_step"] != per_step or r["launch_shapes"] != r["launch_shapes_expected"]:
                faults.append(f"launches {r['launches_per_step']} at {r['launch_shapes']}")
            if not all(math.isfinite(x) for x in r["losses"]):
                faults.append("a loss is not finite")
        if faults:
            failed[case] = faults
    if failed:
        raise AssertionError(f"19f: {failed}: {json.dumps(out)}")
    return out


def reference19f(llama, work: Path, card: str) -> dict:
    from modal_examples_tpu_torch import training

    t0 = time.monotonic()
    refs = train19f_reference(llama, training, work)
    log(f"19f's one-rank references ({card}): {time.monotonic() - t0:.1f}s: "
        f"{json.dumps({k: {n: v[n] for n in ('loss', 'bytes', 's')} for k, v in refs.items()})}")
    return refs


def run19f(g, llama, refs: dict, card: str) -> dict:
    """19f in the two ranks of gang ``g``, held (:func:`check19f`); its
    summary with the launches of both ranks' steps summed."""
    t0 = time.monotonic()
    ranks = g.run(train19f, refs)
    out = check19f(llama, ranks)
    out["launches"] = {}
    for r in ranks:
        for case in r.values():
            for k, v in case["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
    out["seconds"] = time.monotonic() - t0
    log(f"19f TP=2 and FSDP=2 training, two ranks sharing one card over gloo ({card}): {json.dumps(out)}")
    return out


def phase19f(llama, card: str) -> dict:
    """19f alone (``benchmarks_torch/parallel_phase.py --only 19f``): the
    references, then two gloo ranks for the three cases."""
    from modal_examples_tpu_torch.parallel.cluster import RankGang

    work = ROOT / "build" / "phase19f"
    work.mkdir(parents=True, exist_ok=True)
    try:
        refs = reference19f(llama, work, card)
        with RankGang(2, backend="gloo", device="cuda") as g:
            return run19f(g, llama, refs, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train19f(rank: int, refs: dict) -> dict:
    """19f (two ranks sharing the card over gloo): each case of
    ``train19f_cases`` in turn (:func:`train19f_case`)."""
    from modal_examples_tpu_torch.models import llama

    return {case: train19f_case(rank, case, refs[train19f_reference_key(case)]) for case in train19f_cases(llama)}


def phase_parallel(llama, metrics: dict, card: str) -> dict:
    """Phase 19: tensor and data parallelism, in rank processes that end
    with the phase (``parallel.cluster.RankGang``), so no process group
    outlives it."""
    from modal_examples_tpu_torch.parallel.cluster import RankGang

    t0 = time.monotonic()
    work = ROOT / "build" / "phase19"
    work.mkdir(parents=True, exist_ok=True)
    rows_path, ref_path = work / "phase3_rows.json", work / "onecard_logits.pt"
    rows_path.write_text(json.dumps([[list(t), f] for t, f in metrics["tokens"]]))
    tp19_reference(llama, ref_path)
    gc.collect()
    torch.cuda.empty_cache()
    refs19f = reference19f(llama, work, card)
    out = {"card": card}
    with RankGang(1, backend="nccl", device="cuda") as g:
        (out["19a"],) = g.run(tp19a, str(rows_path))
    log(f"19a one rank over NCCL ({card}): {json.dumps(out['19a'])}")
    with RankGang(2, backend="gloo", device="cuda") as g:
        out["19b"] = g.run(tp19b, str(ref_path))
        log(f"19b two ranks sharing one card over gloo ({card}): {json.dumps(out['19b'])}")
        out["19c"] = g.run(dp19c)
        log(f"19c data-parallel LoRA, two ranks sharing one card over gloo ({card}): {json.dumps(out['19c'])}")
        out["19d"] = g.run(ring19d)
        log(f"19d ring and Ulysses attention, two ranks sharing one card over gloo ({card}): "
            f"{json.dumps(out['19d'])}")
        out["19f"] = run19f(g, llama, refs19f, card)
    out["19e"] = phase19_clustered(card)
    shutil.rmtree(work, ignore_errors=True)
    parts = [out["19a"]["launches"], *(r["launches"] for key in ("19c", "19d") for r in out[key]),
             out["19f"]["launches"]]
    lead, follower = out["19b"]
    for label, burst in lead["bursts"].items():
        # the follower's whole run, less the warm-up both ranks ran
        parts += [burst["launches"], {k: v - burst["warm_up"].get(k, 0)
                                      for k, v in follower["bursts"][label]["launches"].items()}]
    launches: dict = {}
    for part in parts:
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    launches["flash_fwd"] = launches.get("flash_fwd", 0) + out["19e"]["k1_launches"]
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t0
    return out


# -- phase 20: C11's f32 flash instances, A11's models --------------------------

# f32 instances against their plain versions: max|out - plain| / max|plain|
# (f32 products in both, sums in another order)
F32_TOL = 1e-4
# (B, Hq, Hkv, S, Skv, q_offset, causal, D, nonzero dlse); the backward runs
# where S == Skv and q_offset == 0 (self-attention, as in JAX)
F32_CASES = [
    (8, 6, 6, 256, 256, 0, True, 64, False),     # GPT's default config: dim 384, 6 heads, block 256, B=8
    (2, 4, 4, 256, 256, 0, True, 32, False),     # GPT's tiny head dim
    (2, 8, 8, 256, 256, 0, True, 128, False),
    (2, 8, 2, 300, 300, 0, True, 64, False),     # ragged S, causal, GQA
    (2, 8, 8, 300, 300, 0, False, 64, True),     # ragged S, full attention, an lse cotangent
    (2, 8, 2, 256, 256, 0, True, 128, True),     # GQA at D=128 with an lse cotangent
    (1, 8, 8, 200, 700, 496, True, 64, False),   # a chunk at q_offset 496 over a ragged Skv (forward only)
    (8, 4, 4, 128, 128, 0, True, 16, False),     # the GPT sweep's dim 64 / 4 heads: D=16, zero-padded to 32
]
# the planted faults, each as the kernels it builds and its edits (a file of
# csrc -> (line, faulty line)): each kernel's last tile of the other side
# dropped (the dK/dV kernel's last query tile of each head); and in all
# three, on the tensor cores, the small parts zeroed, so the two big.small
# products add nothing: one TF32 pass
F32_FAULTS = {
    "last tile dropped": (["flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"], {
        "flash_fwd_f32.cu": ("const int n_tiles = (kv_end + BK - 1) / BK;",
                             "const int n_tiles = (kv_end + BK - 1) / BK - 1;"),
        "flash_bwd_dq_f32.cu": ("const int n_tiles = (kv_end + BK - 1) / BK;",
                                "const int n_tiles = (kv_end + BK - 1) / BK - 1;"),
        "flash_bwd_dkv_f32.cu": ("const int n_qt = (S - q_begin + BQ - 1) / BQ;",
                                 "const int n_qt = (S - q_begin + BQ - 1) / BQ - 1;")}),
    "one TF32 pass": (["flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"], {
        "flash_tf32.cuh": ("  small = round_tf32(x - __uint_as_float(big));", "  small = 0u;")}),
}


def rand_f32(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)


def f32_launch_all(fa, q, k, v, do, dlse, *, causal, q_offset, scale) -> tuple:
    """The three f32 instances on one case: (o, lse) and, for
    self-attention, (dq, dk, dv) from the kernel's own o and lse."""
    o, lse = fa.flash_forward_f32_cuda(q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset)
    if do is None:
        return (o, lse), None
    delta = (do * o).sum(dim=-1)
    args = (q, k, v, do, lse, delta, dlse)
    dq = fa.flash_bwd_dq_f32_cuda(*args, causal=causal, sm_scale=scale)
    dk, dv = fa.flash_bwd_dkv_f32_cuda(*args, causal=causal, sm_scale=scale)
    return (o, lse), (dq, dk, dv)


def f32_case(fa, gen, B, Hq, Hkv, S, Skv, q_offset, causal, D, nz) -> dict:
    """One case of ``F32_CASES``: each instance launched twice (bitwise
    equal required) and held against its plain twin on the same inputs
    (the backward's from the kernel's own o and lse) at ``F32_TOL``."""
    q, k, v = rand_f32(gen, B, Hq, S, D), rand_f32(gen, B, Hkv, Skv, D), rand_f32(gen, B, Hkv, Skv, D)
    bwd = S == Skv and q_offset == 0
    do = rand_f32(gen, B, Hq, S, D) if bwd else None
    dlse = (rand_f32(gen, B, Hq, S) if nz else torch.zeros(B, Hq, S, device="cuda")) if bwd else None
    scale = D**-0.5
    fwd, grads = f32_launch_all(fa, q, k, v, do, dlse, causal=causal, q_offset=q_offset, scale=scale)
    fwd2, grads2 = f32_launch_all(fa, q, k, v, do, dlse, causal=causal, q_offset=q_offset, scale=scale)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(fwd + (grads or ()), fwd2 + (grads2 or ())))
    want_o, want_lse = fa.flash_forward_f32_plain(q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset)
    r = {"case": f"B={B} Hq={Hq} Hkv={Hkv} S={S} Skv={Skv} q_offset={q_offset} causal={causal} D={D} "
                 f"dlse={'randn' if nz else 0}",
         "bitwise": bitwise, "o": rel_err(fwd[0], want_o), "lse": rel_err(fwd[1], want_lse),
         "abs": {"flash_fwd_f32": max(max_err(fwd[0], want_o), max_err(fwd[1], want_lse))}}
    if bwd:
        o, lse = fwd
        delta = (do * o).sum(dim=-1)
        pa = (q, k, v, do, lse, delta, dlse)
        want_dq = fa.flash_bwd_dq_f32_plain(*pa, causal=causal, sm_scale=scale)
        want_dk, want_dv = fa.flash_bwd_dkv_f32_plain(*pa, causal=causal, sm_scale=scale)
        r.update(dq=rel_err(grads[0], want_dq), dk=rel_err(grads[1], want_dk), dv=rel_err(grads[2], want_dv))
        r["abs"]["flash_bwd_dq_f32"] = max_err(grads[0], want_dq)
        r["abs"]["flash_bwd_dkv_f32"] = max(max_err(grads[1], want_dk), max_err(grads[2], want_dv))
    return r


def f32_passes(r: dict) -> bool:
    return all(r[key] <= F32_TOL for key in ("o", "lse", "dq", "dk", "dv") if key in r)


def build_variants(tag: str, names: list, edits: dict) -> dict:
    """The libraries of ``csrc/<name>.cu`` for each of ``names``, built
    together from one copy of ``csrc`` under ``build/variants/<tag>`` with
    each file of ``edits`` (path -> (old line, new line), the old line once
    in that file) changed: planted faults."""
    import ctypes

    from modal_examples_tpu_torch.ops import _build

    root = ROOT / "build" / "variants" / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    for path, (old, new) in edits.items():
        src = (root / "csrc" / path).read_text()
        if src.count(old) != 1:
            raise AssertionError(f"the planted fault's line {old!r} is not once in {path}")
        (root / "csrc" / path).write_text(src.replace(old, new))
    here = (_build.CSRC, _build.BUILD_DIR)
    _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "kernels"
    try:
        _build.build(list(names))
        libs = {name: ctypes.CDLL(str(_build.library_path(name))) for name in names}
    finally:
        _build.CSRC, _build.BUILD_DIR = here
    for name, lib in libs.items():
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes, err_fn.restype = [ctypes.c_int], ctypes.c_char_p
    return libs


class swapped_libs:
    """``_build``'s loaded libraries replaced by ``libs`` for the block's
    duration (the wrappers then launch the variants)."""

    def __init__(self, libs: dict):
        self.libs = libs

    def __enter__(self):
        from modal_examples_tpu_torch.ops import _build

        for name in self.libs:
            _build.load(name)  # the real one loaded, so its slot can be restored
        self.saved = {name: _build._libs[name] for name in self.libs}
        _build._libs.update(self.libs)

    def __exit__(self, *exc):
        from modal_examples_tpu_torch.ops import _build

        _build._libs.update(self.saved)


def f32_fault_refused(fa, faults=tuple(F32_FAULTS)) -> dict:
    """The planted faults (``F32_FAULTS``) run on GPT's default case: the
    same check must refuse each kernel's variant. Returns {fault: {kernel:
    refused}}."""
    B, Hq, Hkv, S, Skv, q_offset, causal, D, nz = F32_CASES[0]
    refused = {}
    for fault in faults:
        names, edits = F32_FAULTS[fault]
        libs = build_variants("flash-f32-" + fault.replace(" ", "-"), names, edits)
        with swapped_libs(libs):
            r = f32_case(fa, torch.Generator(device="cuda").manual_seed(20), B, Hq, Hkv, S, Skv, q_offset,
                         causal, D, nz)
        rel = {"flash_fwd_f32": r["o"], "flash_bwd_dq_f32": r["dq"], "flash_bwd_dkv_f32": max(r["dk"], r["dv"])}
        refused[fault] = {name: rel[name] > F32_TOL for name in names}
        log(f"20a planted faults ({fault}): rel o {r['o']:.3g}, lse {r['lse']:.3g}, dq {r['dq']:.3g}, "
            f"dk {r['dk']:.3g}, dv {r['dv']:.3g}; refused {refused[fault]}")
    if not all(ok for by_name in refused.values() for ok in by_name.values()):
        raise AssertionError(f"the f32 flash check did not refuse a planted fault: {refused}")
    return refused


# the GPT sweep's attention (examples/06_gpu_and_ml/hyperparameter-sweep/
# hp_sweep_gpt.py: dim 64 over 4 heads, block 128, batch 8): (B, Hq, S)
SWEEP_SHAPE = (8, 4, 128)


def f32_padding_cost(fa) -> dict:
    """The cost of C12's zero-padding at the GPT sweep's D=16: each f32
    wrapper's time, and the backward's (``_flash_backward``: delta, then
    dQ and dK/dV on inputs padded once for both), in single calls and 50
    back-to-back between CUDA events, the pad copies included, at D=16
    (padded to the D=32 instance; outputs views of the first 16 columns)
    against the same calls at D=32, which copy nothing, causal."""
    B, H, S = SWEEP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(26)
    out = {}
    for D in (16, 32):
        q, k, v, do = (rand_f32(gen, B, H, S, D) for _ in range(4))
        scale = D**-0.5
        o, lse = fa.flash_forward_f32_cuda(q, k, v, causal=True, sm_scale=scale)
        dlse = torch.zeros_like(lse)
        args = (q, k, v, do, lse, (do * o).sum(dim=-1), dlse)
        calls = {"flash_fwd_f32": lambda: fa.flash_forward_f32_cuda(q, k, v, causal=True, sm_scale=scale),
                 "flash_bwd_dq_f32": lambda: fa.flash_bwd_dq_f32_cuda(*args, causal=True, sm_scale=scale),
                 "flash_bwd_dkv_f32": lambda: fa.flash_bwd_dkv_f32_cuda(*args, causal=True, sm_scale=scale),
                 "backward": lambda: fa._flash_backward(q, k, v, o, lse, do, dlse, causal=True, sm_scale=scale)}
        out[f"D={D}"] = {name: {"ms": time_ms(fn), "ms_b2b": back_to_back_ms(fn)} for name, fn in calls.items()}
    log(f"20a C12's padding at B={B} H={H} S={S} causal, f32: D=16 (padded to 32) {out['D=16']} against the "
        f"D=32 instance {out['D=32']}")
    return out


def phase20_flash_f32(fa, errs: dict) -> dict:
    """20a: K1-f32, K5-f32 and K6-f32 against their plain versions at
    ``F32_CASES`` (plain products with TF32 off), bitwise run to run, the
    planted faults refused, and the padding's cost at D=16."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    for case in F32_CASES:
        r = f32_case(fa, gen, *case)
        log(f"20a f32 flash {r['case']}: rel o {r['o']:.3g} lse {r['lse']:.3g}"
            + (f" dq {r['dq']:.3g} dk {r['dk']:.3g} dv {r['dv']:.3g}" if "dq" in r else "")
            + f"; bitwise run to run {r['bitwise']}")
        if not (f32_passes(r) and r["bitwise"]):
            raise AssertionError(f"an f32 flash instance disagrees with its plain version (tolerance {F32_TOL}) "
                                 f"or is not bitwise run to run: {r}")
        for name, e in r["abs"].items():
            errs[name] = max(errs.get(name, 0.0), e)
        rows.append({k: r[k] for k in r if k != "abs"})
    return {"cases": rows, "faults_refused": f32_fault_refused(fa), "padding_cost": f32_padding_cost(fa)}


# 20b: VLM serving at LLaVA-1.5-7B width
VLM_TEXT = "Describe the picture in one sentence."
#: phase 3's requests served beside the image requests (each in its own
#: bucket, greedy or seeded, so their rows must be phase 3's)
VLM_TEXT_ROWS = (0, 2, 3, 4, 6)
VLM_AGREE = 1e-4  # the tower on the card against its CPU run, of the largest value


def vlm_images() -> dict:
    """Two 224 px RGB test images from a seed (uint8): a gradient with
    noise, and stripes with noise."""
    rng = np.random.default_rng(20)
    yy, xx = np.mgrid[0:224, 0:224]
    a = np.stack([xx, yy, (xx + yy) // 2], axis=-1) + rng.integers(0, 24, (224, 224, 3))
    b = np.stack([(xx // 16 % 2) * 200, (yy // 28 % 2) * 180, np.full_like(xx, 90)], axis=-1)
    b = b + rng.integers(0, 40, (224, 224, 3))
    return {"A": np.clip(a, 0, 255).astype(np.uint8), "B": np.clip(b, 0, 255).astype(np.uint8)}


def png_uri(img) -> str:
    import base64

    from modal_examples_tpu_torch.utils import images

    return "data:image/png;base64," + base64.b64encode(images.to_png(img)).decode()


def sse(base: str, path: str, body: dict) -> dict:
    """One streamed completion (chat or text) with usage: its text, finish,
    usage and wall time."""
    req = urllib.request.Request(base + path, data=json.dumps({**body, "stream": True,
                                                               "stream_options": {"include_usage": True}}).encode(),
                                 headers={"content-type": "application/json"})
    t0 = time.monotonic()
    pieces, finish, usage = [], None, None
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: status {r.status}")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[len("data: "):])
            if chunk.get("usage"):
                usage = chunk["usage"]
            for c in chunk.get("choices") or []:
                piece = (c.get("delta") or {}).get("content") if "delta" in c else c.get("text")
                if piece:
                    pieces.append(piece)
                finish = c.get("finish_reason") or finish
    return {"text": "".join(pieces), "finish": finish, "usage": usage, "wall_s": time.monotonic() - t0}


def vlm_body(img) -> dict:
    """A chat request for ``img``: one seeded row. Both images' rows draw
    the same noise (seed and positions), so where they differ the image
    made them differ; random weights' greedy rows often do not depend on
    an image at all (their argmax follows the last text tokens)."""
    return {"messages": [{"role": "user", "content": [
        {"type": "text", "text": VLM_TEXT}, {"type": "image_url", "image_url": {"url": png_uri(img)}}]}],
        "max_tokens": 24, "temperature": 1.0, "seed": 77}


def text_body(prompt: str, sp) -> dict:
    body = {"prompt": prompt, "max_tokens": sp.max_tokens, "temperature": sp.temperature, "top_p": sp.top_p}
    if sp.seed is not None:
        body["seed"] = sp.seed
    return body


def vlm_dense_check(llama, layers, reference, vlm, params, cfg, vcfg, vparams, image) -> dict:
    """An image request's prefill logits (its image tokens' embeddings and
    40 text tokens) and its first decode step's, through the served
    functions (``prefill(input_embeds=)`` with K1 and K3, ``decode_step``
    with K2), against the dense plain forward with the same
    ``input_embeds``: the logit contract and the top-2 margin rule."""
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    n_img = vcfg.n_image_tokens
    gen = torch.Generator(device="cuda").manual_seed(6)
    text = torch.randint(0, 256, (1, 40), generator=gen, device="cuda", dtype=torch.int32)
    toks = torch.cat([torch.zeros((1, n_img), dtype=torch.int32, device="cuda"), text], dim=1)
    S = toks.shape[1]
    embeds = vlm.encode_image(vparams, image[None], vcfg)
    cache = PagedKVCache.create(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                n_pages=33, page_size=16, kv_dtype=cfg.dtype, device="cuda")
    tables = torch.arange(1, 33, device="cuda", dtype=torch.int32)[None]
    padded = torch.zeros((1, 512), dtype=torch.int32, device="cuda")
    padded[0, : S - 1] = toks[0, : S - 1]
    pre, _, _ = llama.prefill(params, padded, cache.k_pages, cache.v_pages, tables,
                              torch.tensor([S - 1], device="cuda"), cfg, input_embeds=embeds)
    dec, _, _ = llama.decode_step(params, toks[0, S - 1:], torch.tensor([S - 1], device="cuda"), cache.k_pages,
                                  cache.v_pages, tables, torch.tensor([True], device="cuda"), cfg)
    out = {}
    for name, got, n in (("prefill", pre, S - 1), ("decode", dec, S)):
        ref = dense_reference_logits(params, cfg, toks[:, :n], layers, reference, input_embeds=embeds)
        out[name] = margin_rule(got, ref)
        log(f"20b image request's {name} logits vs the dense plain forward with input_embeds: {out[name]}")
        if not out[name]["ok"]:
            raise AssertionError(f"20b: the image request's {name} logits break the logit contract")
    return out


def phase20_vlm(fa, pa, llama, layers, reference, LLMEngine, OpenAIServer, SamplingParams, params, phase3: dict,
                decode, card: str) -> dict:
    """20b: CLIP ViT-L/14 at 224 px (f32, random from a seed) and its
    projector in front of phase 3's Llama-2-7B bf16 weights (LLaVA-1.5-7B's
    shape), served through ``OpenAIServer``."""
    from modal_examples_tpu_torch.models import vlm
    from modal_examples_tpu_torch.utils import tree as tree_util

    t_phase = time.monotonic()
    cfg = llama.LlamaConfig.llama2_7b()
    vcfg = vlm.VLMConfig(vision=vlm.ViTConfig.clip_vit_l_14(), llm_dim=cfg.dim)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    vparams = vlm.init_vision_params(vcfg, seed=20, device="cuda")
    tower_gb = (torch.cuda.memory_allocated() - before) / 1e9
    imgs = vlm_images()
    pixels = {k: torch.from_numpy(vlm.preprocess_image(v, 224)).cuda() for k, v in imgs.items()}
    # the tower on the card against its CPU run (same f32 weights and image)
    emb = vlm.encode_image(vparams, pixels["A"][None], vcfg)
    cpu_params = tree_util.map(lambda t: t.cpu(), vparams)
    want = vlm.encode_image(cpu_params, pixels["A"][None].cpu(), vcfg)
    del cpu_params
    tower_rel = max_err(emb.cpu(), want) / want.abs().max().item()
    log(f"20b CLIP ViT-L/14 tower + projector ({tower_gb:.3f} GB f32): card vs CPU max|d|/max {tower_rel:.3g}")
    if not tower_rel <= VLM_AGREE:
        raise AssertionError(f"20b: the tower's embeddings on the card disagree with its CPU run: {tower_rel}")
    four = torch.stack([pixels["A"], pixels["B"]] * 2)  # a prefill group of image rows (prefill_batch 4)
    tower_ms = time_ms(lambda: vlm.encode_image(vparams, four, vcfg), reps=10)
    contract = vlm_dense_check(llama, layers, reference, vlm, params, cfg, vcfg, vparams, pixels["A"])

    eng = LLMEngine(cfg, params, vision=(vcfg, vparams), **SERVE_KW)
    eng.generate("warm up", SamplingParams(max_tokens=2, temperature=0.0))
    submitted = []  # the server's engine requests, for their token rows
    submit_request = eng.submit_request

    def capture(req):
        submitted.append(req)
        return submit_request(req)

    eng.submit_request = capture
    srv = OpenAIServer(eng, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    burst_requests = make_requests(SamplingParams)
    jobs = [("image A", "/v1/chat/completions", vlm_body(imgs["A"])),
            ("image B", "/v1/chat/completions", vlm_body(imgs["B"]))]
    jobs += [(f"text row {i}", "/v1/completions", text_body(*burst_requests[i])) for i in VLM_TEXT_ROWS]
    results: dict = {}
    try:
        settle(eng)
        fa.launches = pa.decode_launches = pa.scatter_launches = 0
        t0 = time.monotonic()

        def run(label, path, body):
            results[label] = sse(base, path, body)

        threads = [threading.Thread(target=run, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {"flash_fwd": fa.launches, "paged_decode": pa.decode_launches, "kv_scatter": pa.scatter_launches}
        if len(results) != len(jobs) or min(counts.values()) <= 0:
            raise AssertionError(f"20b: {len(results)} of {len(jobs)} answered; launches {counts}")
        again = sse(base, "/v1/chat/completions", vlm_body(imgs["A"]))  # the shared image, now cached
        settle(eng)
        check_pages_returned(eng, "20b")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        srv.stop()
        eng.stop()
    n_img = vcfg.n_image_tokens
    cached = again["usage"]["prompt_tokens_details"]["cached_tokens"]
    if cached < (n_img // eng.cache.page_size) * eng.cache.page_size:
        raise AssertionError(f"20b: the shared image's second request reused {cached} tokens, not its "
                             f"{n_img} image tokens' pages")
    pre_a = vlm.preprocess_image(imgs["A"], 224)
    image_rows = {("A" if np.array_equal(r.image, pre_a) else "B"): r for r in submitted[:len(jobs)]
                  if r.image is not None}
    if sorted(image_rows) != ["A", "B"] or image_rows["A"].generated_tokens == image_rows["B"].generated_tokens:
        raise AssertionError("20b: the two images' seeded rows (same seed, same text) are the same")
    rows_equal = 0
    by_prompt = {r.prompt: r for r in submitted[:len(jobs)] if r.image is None}
    for i in VLM_TEXT_ROWS:
        prompt, sp = burst_requests[i]
        got, want = by_prompt[prompt], phase3["tokens"][i]
        if decode(got.generated_tokens) != results[f"text row {i}"]["text"]:
            raise AssertionError(f"20b: text row {i}'s streamed text is not its request's tokens")
        if sp.temperature > 0 and sp.seed is None:
            continue
        if (got.generated_tokens, got.finish_reason) != tuple(want):
            raise AssertionError(f"20b: text row {i} differs from phase 3's row beside the image requests")
        rows_equal += 1
    tokens_out = sum(r["usage"]["completion_tokens"] for r in results.values())
    out = {
        "tower_gb": tower_gb, "tower_vs_cpu_rel": tower_rel, "tower_ms_batch4": tower_ms,
        "contract": contract, "launches": counts,
        # TTFT on the engine's clock: from the request's creation to its first token
        "image_ttft_s": [image_rows[k].first_token_at - image_rows[k].created for k in ("A", "B")],
        "text_ttft_s_median": statistics.median(by_prompt[burst_requests[i][0]].first_token_at
                                                - by_prompt[burst_requests[i][0]].created for i in VLM_TEXT_ROWS),
        "cached_image_ttft_s": submitted[-1].first_token_at - submitted[-1].created, "cached_tokens": cached,
        "burst_tok_per_s": tokens_out / wall, "burst_wall_s": wall, "text_rows_equal_to_phase3": rows_equal,
        "same_image_same_tokens": submitted[-1].generated_tokens == image_rows["A"].generated_tokens,
        "peak_gb": peak_gb, "seconds": time.monotonic() - t_phase,
    }
    log(f"20b VLM serving ({card}): {json.dumps(out)}")
    del vparams
    return out


# 20c: GPT and an f32 Llama through the f32 flash instances
F32_GRAD_COSINE_MIN = 0.9999
F32_LORA_CFG = dict(vocab_size=32000, dim=1024, n_layers=8, n_heads=16, n_kv_heads=8, ffn_dim=2816,
                    max_seq_len=1024, dtype="float32")  # head dim 64: the f32 instances' widths


def grads_cosine(a: dict, b: dict, label: str) -> dict:
    """Per leaf: cosine and max relative error of ``a`` against ``b``, held
    at ``F32_GRAD_COSINE_MIN``."""
    out = {}
    for k in a:
        x, y = a[k].float().flatten(), b[k].float().flatten()
        out[k] = {"cosine": torch.nn.functional.cosine_similarity(x, y, dim=0).item(),
                  "max_rel_err": max_err(x, y) / max(y.abs().max().item(), 1e-30)}
    worst = min(out, key=lambda k: out[k]["cosine"])
    log(f"{label}: worst cosine {out[worst]['cosine']:.7f} ({worst}), max rel err "
        f"{max(v['max_rel_err'] for v in out.values()):.3g}")
    if not out[worst]["cosine"] >= F32_GRAD_COSINE_MIN:
        raise AssertionError(f"{label}: {worst} cosine {out[worst]['cosine']} < {F32_GRAD_COSINE_MIN}")
    return out


def f32_counts(fa) -> dict:
    return {"flash_fwd_f32": fa.f32_launches, "flash_bwd_dq_f32": fa.dq_f32_launches,
            "flash_bwd_dkv_f32": fa.dkv_f32_launches}


def zero_f32_counts(fa) -> None:
    fa.f32_launches = fa.dq_f32_launches = fa.dkv_f32_launches = 0


def timed_steps(trainer, state, batch, steps: int) -> tuple:
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return state, {"losses": losses, "step_ms": [1e3 * s for s in step_s]}


def phase20_gpt(fa, training, card: str) -> dict:
    """GPT at its default config (f32, 6 layers, dim 384, block 256, B=8):
    the gradients through K1/K5/K6-f32 against ``attn_impl="xla"``, then
    1 + 2 counted ``Trainer`` steps (3 x 6 launches of each f32 instance)
    and a 32-token ``generate``."""
    import torch.nn.functional as F

    from modal_examples_tpu_torch.models import gpt
    from modal_examples_tpu_torch.serving import sampling
    from modal_examples_tpu_torch.utils import tree as tree_util

    cfg = gpt.GPTConfig()
    params = gpt.init_params(cfg, seed=20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, cfg.block_size + 1), generator=gen, device="cuda")}

    def loss_fn(p, b, attn_impl="flash"):
        logits = gpt.forward(p, b["tokens"][:, :-1], cfg, attn_impl=attn_impl)
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size), b["tokens"][:, 1:].reshape(-1))

    def grads(attn_impl):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_util.leaves(params)]
        g = torch.autograd.grad(loss_fn(tree_util.unflatten(params, leaves), batch, attn_impl), leaves)
        return {str(i): t for i, t in enumerate(g)}

    check = grads_cosine(grads("flash"), grads("xla"), "20c GPT gradients, flash (f32 instances) vs xla")
    trainer = training.Trainer(loss_fn, training.make_optimizer(3e-4))
    state = trainer.init_state(params)
    zero_f32_counts(fa)
    state, steps = timed_steps(trainer, state, batch, 3)
    counts = f32_counts(fa)
    if counts != {k: 3 * cfg.n_layers for k in counts}:
        raise AssertionError(f"20c GPT steps launched {counts}: want {3 * cfg.n_layers} of each f32 instance")
    prompt = batch["tokens"][0, :16]
    t0 = time.monotonic()
    toks = gpt.generate(state.params, cfg, prompt, 32, sampling.prng_key(0))
    gen_s = time.monotonic() - t0
    if toks.shape != (32,) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"20c GPT generate gave {toks}")
    out = {"grad_cosine_min": min(v["cosine"] for v in check.values()),
           "grad_max_rel_err": max(v["max_rel_err"] for v in check.values()), **steps,
           "launches": counts, "generate_32_s": gen_s}
    log(f"20c GPT default config ({card}): {json.dumps(out)}")
    return out


def phase20_llama_f32(fa, llama, lora, training, card: str) -> dict:
    """C11 shown repaired: ``Trainer`` over an f32 Llama (head dim 64) with
    rank-16 LoRA on the seven projections, B=2 x S=512, through the f32
    flash instances: the adapter gradients against ``attn_impl="xla"``
    (cosine >= ``F32_GRAD_COSINE_MIN``), then 1 + 2 counted steps."""
    cfg = llama.LlamaConfig(**F32_LORA_CFG)
    params = llama.init_params(cfg, seed=22, device="cuda")
    lcfg = lora.LoRAConfig(rank=16)
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(23), params, lcfg)
    gen = torch.Generator(device="cuda").manual_seed(24)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device="cuda"),
             "mask": torch.ones((2, 512), device="cuda")}

    def loss_fn(ad, b, attn_impl="flash"):
        logits = llama.forward(params, b["tokens"], cfg, attn_impl=attn_impl, lora=ad, lora_scale=lcfg.scale)
        return training.cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    check = check_grads_against_xla(loss_fn, adapters, batch, lcfg.targets, cosine_min=F32_GRAD_COSINE_MIN)
    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-4))
    state = trainer.init_state(adapters)
    zero_f32_counts(fa)
    state, steps = timed_steps(trainer, state, batch, 3)
    counts = f32_counts(fa)
    if counts != {k: 3 * cfg.n_layers for k in counts}:
        raise AssertionError(f"20c f32 Llama LoRA steps launched {counts}: want {3 * cfg.n_layers} of each")
    out = {"grad_cosine_min": min(v["cosine"] for v in check.values()), **steps, "launches": counts}
    log(f"20c f32 Llama LoRA through Trainer with attn_impl='flash' ({card}): {json.dumps(out)}")
    return out


# 20d: the detector, OCR, SAM and the video DiT at their default configs
MODEL_AGREE = 1e-4  # the card against the port's CPU run, of the largest value


def card_vs_cpu(loss_fn, params, batch, label: str) -> dict:
    """The loss and every gradient of ``loss_fn(params, batch)`` on the card
    against the same on the CPU (f32, TF32 off): each within
    ``MODEL_AGREE`` of its largest value (the loss relative)."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    def step(p, b):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_util.leaves(p)]
        loss = loss_fn(tree_util.unflatten(p, leaves), b)
        return loss.detach().float(), torch.autograd.grad(loss, leaves, allow_unused=True)

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    lg, gg = step(params, batch)
    lc, gc_ = step(tree_util.map(cpu, params), tree_util.map(cpu, batch))
    loss_rel = abs(lg.item() - lc.item()) / max(abs(lc.item()), 1e-30)
    grad_rel = max(max_err(a.cpu(), b) / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(gg, gc_) if a is not None and b.abs().max() > 0)
    out = {"loss": lg.item(), "loss_rel": loss_rel, "grad_rel_max": grad_rel}
    log(f"20d {label}, card against CPU: {json.dumps(out)}")
    if not (loss_rel <= MODEL_AGREE and grad_rel <= MODEL_AGREE):
        raise AssertionError(f"20d {label}: the card disagrees with the port's CPU run: {out}")
    return out


def one_step(training, loss_fn, params, batch, label: str) -> dict:
    """One ``Trainer`` step: a finite loss, every parameter tree changed."""
    from modal_examples_tpu_torch.utils import tree as tree_util

    trainer = training.Trainer(loss_fn, training.make_optimizer(1e-3))
    state = trainer.init_state(params)
    t0 = time.monotonic()
    new, m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.monotonic() - t0)
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(tree_util.leaves(new.params), tree_util.leaves(params)))
    if not (math.isfinite(m["loss"].item()) and moved > 0):
        raise AssertionError(f"20d {label}: step loss {m['loss'].item()}, {moved} leaves changed")
    return {"step_loss": m["loss"].item(), "step_ms": ms, "leaves_changed": moved,
            "leaves": len(tree_util.leaves(params))}


def phase20_models(training, card: str) -> dict:
    """20d: each model at its default config on the card against the port's
    CPU run of the same f32 weights and inputs, one ``Trainer`` step each,
    and ``video.sample`` with the first frame pinned."""
    from modal_examples_tpu_torch.models import ocr, segmentation, video, vision

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(30)
    # the detector
    dcfg = vision.DetectorConfig()
    dparams = vision.init_params(dcfg, seed=30, device="cuda")
    dbatch = vision.synthetic_batch(gen, 16, dcfg)
    dloss = lambda p, b: vision.detection_loss(p, b, dcfg)  # noqa: E731
    out["detector"] = {**card_vs_cpu(dloss, dparams, dbatch, "detector"),
                       **one_step(training, dloss, dparams, dbatch, "detector")}
    # OCR: numpy lines (the card's machine has no PIL to render text)
    ocfg = ocr.OCRConfig()
    oparams = ocr.init_params(ocfg, seed=31, device="cuda")
    rng = np.random.default_rng(31)
    labels = np.zeros((16, 14), np.int32)
    for i in range(16):
        n = int(rng.integers(3, 12))
        labels[i, :n] = rng.integers(1, len(ocr.CHARSET) + 1, n)
    obatch = {"images": torch.from_numpy(rng.random((16, ocfg.height, ocfg.width, 1), dtype=np.float32)).cuda(),
              "labels": torch.from_numpy(labels).cuda()}
    oloss = lambda p, b: ocr.ctc_loss(p, b["images"], b["labels"], ocfg)  # noqa: E731
    out["ocr"] = {**card_vs_cpu(oloss, oparams, obatch, "OCR"), **one_step(training, oloss, oparams, obatch, "OCR"),
                  "greedy": ocr.greedy_decode(oparams, obatch["images"][:2], ocfg)}
    # SAM
    scfg = segmentation.SAMConfig()
    sparams = segmentation.init_params(scfg, seed=32, device="cuda")
    imgs, pts, masks = segmentation.synthetic_batch(gen, 8, scfg)
    sbatch = {"images": imgs, "points": pts, "masks": masks}
    sloss = lambda p, b: segmentation.segmentation_loss(p, b["images"], b["points"], b["masks"], scfg)  # noqa: E731
    out["sam"] = {**card_vs_cpu(sloss, sparams, sbatch, "SAM"), **one_step(training, sloss, sparams, sbatch, "SAM")}
    # the video DiT: its zero-initialised leaves drawn nonzero so every block computes
    vcfg = video.VideoDiTConfig()
    vparams = video.init_params(vcfg, seed=33, device="cuda")
    for name, t in [*vparams["layers"].items(), *vparams.items()]:
        if isinstance(t, torch.Tensor) and (name.startswith("mod_") or name == "xwo" or name.startswith("final_")):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda").mul_(0.02))
    B = 4
    shape = (B, vcfg.frames, vcfg.img_size, vcfg.img_size, vcfg.channels)
    vbatch = {"video": torch.randn(shape, generator=gen, device="cuda"),
              "text": torch.randn((B, vcfg.text_len, vcfg.text_dim), generator=gen, device="cuda"),
              "t": torch.rand((B,), generator=gen, device="cuda"), "eps": torch.randn(shape, generator=gen, device="cuda"),
              "pin": torch.tensor([True, False, True, False], device="cuda"),
              "drop": torch.tensor([False, False, True, False], device="cuda")}
    vloss = lambda p, b: video.flow_loss(p, b["video"], b["text"], vcfg, t=b["t"], eps=b["eps"], pin=b["pin"],  # noqa: E731
                                         drop=b["drop"])
    out["video"] = {**card_vs_cpu(vloss, vparams, vbatch, "video DiT"),
                    **one_step(training, vloss, vparams, vbatch, "video DiT")}
    first = vbatch["video"][:, 0]
    t0 = time.monotonic()
    clip = video.sample(vparams, vbatch["text"], vcfg, first_frame=first, generator=gen)
    torch.cuda.synchronize()
    if not (torch.equal(clip[:, 0], first) and bool(torch.isfinite(clip).all()) and tuple(clip.shape) == shape):
        raise AssertionError("20d: video.sample did not keep the first frame pinned, or gave a non-finite clip")
    out["video"]["sample_s"] = time.monotonic() - t0
    log(f"20d the detector, OCR, SAM and the video DiT ({card}): {json.dumps(out)}")
    return out


# 20e: GRPO at llama3.2-1b width in bf16
GRPO_PROMPT, GRPO_GROUP, GRPO_NEW = 32, 8, 8
GRPO_RATIO_TOL = 2.0**-7  # bf16's resolution at 1


def phase20_grpo(llama, card: str) -> dict:
    """``GRPOTrainer`` over ``llama32_1b()`` (bf16, random from a seed):
    group 8, a 32-token prompt, 8 new tokens; one warm step, then two more.
    The first step's importance ratio (the reference, still the behavior
    policy, over the rollout) is 1 within bf16's resolution; the update
    moves the policy and leaves the reference alone."""
    from modal_examples_tpu_torch.serving import sampling
    from modal_examples_tpu_torch.training import grpo
    from modal_examples_tpu_torch.utils import tree as tree_util

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.LlamaConfig.llama32_1b()
    params = llama.init_params(cfg, seed=40, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    prompt = torch.randint(0, cfg.vocab_size, (GRPO_PROMPT,), generator=gen, device="cuda")

    def reward(tokens):
        new = tokens[:, GRPO_PROMPT:]
        return ((new % 7 == 0).sum(dim=1).float() + 0.1 * (new[:, 0] % 5).float()).tolist()

    trainer = grpo.GRPOTrainer(cfg, params, reward, grpo.GRPOConfig(group_size=GRPO_GROUP, max_new=GRPO_NEW),
                               learning_rate=1e-5)
    ref_sums = [t.float().sum().item() for t in tree_util.leaves(trainer.ref)]
    step_s, rewards = [], []
    for i in range(3):
        t0 = time.monotonic()
        m = trainer.step(prompt, GRPO_PROMPT, sampling.prng_key(100 + i))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        rewards.append(m)
        if i == 0:  # the first step's ratio: the reference is the policy the rollout came from
            last = trainer.last
            with torch.no_grad():
                lps = grpo._completion_logprobs(trainer.ref, cfg, last["tokens"], GRPO_PROMPT, GRPO_NEW)
            ratio_dev = (torch.exp(lps - last["behavior_lps"]) - 1).abs().max().item()
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(tree_util.leaves(trainer.policy),
                                                           tree_util.leaves(trainer.ref)))
    ref_same = [t.float().sum().item() for t in tree_util.leaves(trainer.ref)] == ref_sums
    out = {"first_step_ratio_max_dev": ratio_dev, "leaves_moved": moved, "ref_unchanged": ref_same,
           "step_s": step_s, "rewards": rewards, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"20e GRPO at llama3.2-1b width, bf16 ({card}): {json.dumps(out)}")
    if not (ratio_dev <= GRPO_RATIO_TOL and moved > 0 and ref_same):
        raise AssertionError(f"20e: ratio deviation {ratio_dev}, {moved} leaves moved, reference unchanged {ref_same}")
    del trainer, params
    return out


def phase_a11(fa, pa, llama, layers, reference, lora, training, LLMEngine, OpenAIServer, SamplingParams, params,
              phase3: dict, decode, errs: dict, card: str) -> dict:
    """Phase 20: C11's f32 flash instances (20a) and A11's models on the card
    (20b-20e). Returns each part's readings, the f32 instances' launches on
    their main path (20c's steps) and the phase's seconds."""
    t0 = time.monotonic()
    out = {"flash_f32": phase20_flash_f32(fa, errs)}
    out["vlm"] = phase20_vlm(fa, pa, llama, layers, reference, LLMEngine, OpenAIServer, SamplingParams, params,
                             phase3, decode, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["gpt"] = phase20_gpt(fa, training, card)
    out["llama_f32_lora"] = phase20_llama_f32(fa, llama, lora, training, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["models"] = phase20_models(training, card)
    out["grpo"] = phase20_grpo(llama, card)
    out["launches"] = {**out["vlm"]["launches"], **{
        k: out["gpt"]["launches"][k] + out["llama_f32_lora"]["launches"][k] for k in out["gpt"]["launches"]}}
    out["seconds"] = time.monotonic() - t0
    return out


# the f32 instances' timed shapes: (label, B, Hq, Hkv, S, D), causal
F32_TIMED = [("GPT's default config", 8, 6, 6, 256, 64),
             ("20c's f32 Llama (F32_LORA_CFG)", 2, 16, 8, 512, 64),
             ("S=1024", 2, 16, 8, 1024, 64),
             ("S=2048", 2, 16, 8, 2048, 64)]


def f32_bounds(flops: float, nbytes: float) -> dict:
    """The least time of an f32-accurate product on the card, both ways: f32
    FMAs at the CUDA cores' peak, and three TF32 passes at the tensor cores'
    (the 3xTF32 split); the smaller names the row's operations bound, the
    bytes over HBM's rate the other side."""
    simt, tf32x3, t_bytes = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    t_ops = min(simt, tf32x3)
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_ms_simt_f32": 1e3 * max(simt, t_bytes), "bound_ms_3xtf32": 1e3 * max(tf32x3, t_bytes)}


def f32_library(q, k, v, do, scale: float):
    """PyTorch's f32 attention on the same causal inputs, forward and
    backward (SDPA's memory-efficient kernels; K and V repeated to every
    query head where Hkv < Hq, as that call takes no GQA): the yardstick
    calls ``(library_fwd, library_bwd)``, never the port's path."""
    G = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
    out_e, lse_e, seed_e, off_e = torch.ops.aten._scaled_dot_product_efficient_attention(
        q, kr, vr, None, True, 0.0, True, scale=scale)

    def library_bwd():
        return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            do, q, kr, vr, None, out_e, lse_e, seed_e, off_e, 0.0, [True, True, True, False], True, scale=scale)

    def library_fwd():
        return torch.ops.aten._scaled_dot_product_efficient_attention(q, kr, vr, None, False, 0.0, True,
                                                                       scale=scale)

    return library_fwd, library_bwd


def f32_timed(fa, label, B, Hq, Hkv, S, D) -> dict:
    """The three f32 instances at one causal shape: single and back-to-back
    launches, their device time, the plain versions, both bounds
    and PyTorch's f32 attention (``f32_library``) on the same inputs.
    Returns {name: readings}."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    q, do = rand_f32(gen, B, Hq, S, D), rand_f32(gen, B, Hq, S, D)
    k, v = rand_f32(gen, B, Hkv, S, D), rand_f32(gen, B, Hkv, S, D)
    scale = D**-0.5
    o, lse = fa.flash_forward_f32_cuda(q, k, v, causal=True, sm_scale=scale)
    delta = (do * o).sum(dim=-1)
    dlse = torch.zeros_like(lse)
    args = (q, k, v, do, lse, delta, dlse)
    one = 2 * 0.5 * S * S * D * B * Hq  # FLOPs of one causal S x S x D product, all query heads
    q_bytes, kv_bytes, row_bytes = B * Hq * S * D * 4, B * Hkv * S * D * 4, B * Hq * S * 4
    library_fwd, library_bwd = f32_library(q, k, v, do, scale)
    specs = [
        ("flash_fwd_f32", lambda: fa.flash_forward_f32_cuda(q, k, v, causal=True, sm_scale=scale),
         lambda: fa.flash_forward_f32_plain(q, k, v, causal=True, sm_scale=scale), 2,
         2 * q_bytes + 2 * kv_bytes + row_bytes, library_fwd, "aten._scaled_dot_product_efficient_attention (f32)"),
        ("flash_bwd_dq_f32", lambda: fa.flash_bwd_dq_f32_cuda(*args, causal=True, sm_scale=scale),
         lambda: fa.flash_bwd_dq_f32_plain(*args, causal=True, sm_scale=scale), 3,
         3 * q_bytes + 2 * kv_bytes + 3 * row_bytes, library_bwd,
         "aten._scaled_dot_product_efficient_attention_backward (f32; dQ, dK and dV together)"),
        ("flash_bwd_dkv_f32", lambda: fa.flash_bwd_dkv_f32_cuda(*args, causal=True, sm_scale=scale),
         lambda: fa.flash_bwd_dkv_f32_plain(*args, causal=True, sm_scale=scale), 4,
         2 * q_bytes + 4 * kv_bytes + 3 * row_bytes, library_bwd,
         "aten._scaled_dot_product_efficient_attention_backward (f32; dQ, dK and dV together)"),
    ]
    out = {}
    for name, kernel, plain, n_products, nbytes, library, library_op in specs:
        r = out[name] = dict(
            ms=time_ms(kernel), ms_b2b=back_to_back_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=time_ms(plain, reps=5), **f32_bounds(n_products * one, nbytes), library_ms=time_ms(library),
            library_ms_b2b=back_to_back_ms(library), library_device_ms=device_ms(library), library_op=library_op,
            shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} causal, f32 ({label})")
        log(f"{name} at {r['shape']}: {r['ms']:.4f} ms, back-to-back {r['ms_b2b']:.4f}, device "
            f"{fmt_ms(r['device_ms'])} (plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} / device "
            f"{fmt_ms(r['library_device_ms'])}, bound {r['bound_ms']:.4f} by {r['bound_by']}: f32 FMAs "
            f"{r['bound_ms_simt_f32']:.4f}, 3xTF32 {r['bound_ms_3xtf32']:.4f})")
    return out


def f32_rows(fa, counts: dict, errs: dict) -> list:
    """The kernels line's rows of the three f32 instances: their readings at
    GPT's default shape (B=8, H=6, S=256, D=64, causal), and at every
    ``F32_TIMED`` shape under ``at_shapes`` beside them (``f32_timed``)."""
    timed = [f32_timed(fa, *shape) for shape in F32_TIMED]
    lines = {"flash_fwd_f32": 40, "flash_bwd_dq_f32": 244, "flash_bwd_dkv_f32": 278}
    return [dict(name=name, route="cuda", source=f"modal_examples_tpu_torch/csrc/{name}.cu",
                 replaces=f"modal_examples_tpu/ops/flash_attention.py:{line} (f32 inputs)", launches=counts[name],
                 max_abs_err=errs[name], **timed[0][name], at_shapes=[t[name] for t in timed])
            for name, line in lines.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the GPU only", file=sys.stderr)
        return 2
    # the engines' request traces and usage journals land in the checkout's build/
    os.environ.setdefault("MTPU_STATE_DIR", str(ROOT / "build" / "state"))
    from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams, training
    from modal_examples_tpu_torch.models import layers, llama, lora, quantize
    from modal_examples_tpu_torch.ops import _build, reference
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.ops import paged_attention as pa
    from modal_examples_tpu_torch.ops import quantized_matmul as qmm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    # plain versions in full f32 (no TF32), stated for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("plain versions: torch.backends.cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False")

    t0 = time.monotonic()
    ptxas = _build.build(verbose=True)
    log(f"phase 1 build: {time.monotonic() - t0:.1f}s for {_build.kernel_names()}")
    for name in SASS_CHECKED:  # registers and spills a thread, per kernel instance
        log(f"{name} ptxas: " + " | ".join(ptxas_summary(ptxas.get(name, ""))))
    check_sass(_build)
    errs = phase_kernels_vs_plain(fa, pa)
    bwd_bitwise = phase_backward_vs_plain(fa, errs)
    phase_int8_kernels_vs_plain(pa, errs)
    log(f"phase 2 kernels vs plain (tolerances {TOL}): {errs}")
    eng, metrics = phase_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams)
    phase_server(eng, OpenAIServer)
    log("phase 4 server: ok")
    params, bf16_cache_bytes = eng.params, eng.cache.bytes()
    decode = eng.tokenizer.decode  # phase 11 holds served texts against phase 3's tokens
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    wb = phase_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params)
    log("phase 3b write-then-attend serving: ok")
    gc.collect()
    torch.cuda.empty_cache()
    int8, qparams = phase_int8_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params,
                                      bf16_cache_bytes)
    log("phase 4 int8 serving: ok")
    gc.collect()
    torch.cuda.empty_cache()
    wb8 = phase_int8_writeback_engine(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, qparams)
    log("phase 3b write-then-attend serving over int8 pages: ok")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    surface = phase_engine_surface(fa, pa, llama, layers, reference, LLMEngine, SamplingParams, params, card)
    log(f"phase 6 engine surface: {json.dumps(surface)}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    pipeline = phase_pipeline(fa, pa, llama, LLMEngine, OpenAIServer, SamplingParams, params, metrics)
    log(f"phase 7 pipelined engine: ok in {time.monotonic() - t0:.1f}s: {json.dumps(pipeline)}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    spec = phase_speculation(fa, pa, llama, layers, reference, LLMEngine, OpenAIServer, SamplingParams, params,
                             metrics)
    log(f"phase 8 speculation: ok in {time.monotonic() - t0:.1f}s: {json.dumps(spec)}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    workloads = phase_inference_workloads(fa, reference, card)
    log(f"phase 9 inference workloads ({card}): ok in {time.monotonic() - t0:.1f}s: {json.dumps(workloads)}")
    observability = phase_observability(fa, pa, llama, LLMEngine, params)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_layers = phase_fleet_layers(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, params,
                                      metrics["tokens"], card)
    free_fleet()
    tiers = phase_tiers_fleet_chaos(fa, pa, qmm, llama, LLMEngine, OpenAIServer, SamplingParams, params, card)
    gc.collect()
    torch.cuda.empty_cache()
    p20 = phase_a11(fa, pa, llama, layers, reference, lora, training, LLMEngine, OpenAIServer, SamplingParams, params,
                    metrics, decode, errs, card)
    log(f"phase 20 C11's f32 flash instances and A11's models ({card}): ok in {p20['seconds']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_training(fa, llama, lora, training, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    lora8 = phase_int8_lora(fa, qmm, llama, lora, training, quantize, train["peak_gb"])
    log(f"phase 12 int8 LoRA ({card}): ok in {time.monotonic() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    keep = {}
    mixtral = phase_mixtral(fa, pa, llama, layers, reference, LLMEngine, OpenAIServer, SamplingParams, keep)
    log(f"phase 10 mixtral-8x7b ({card}): ok in {time.monotonic() - t0:.1f}s: {json.dumps(mixtral)}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    from modal_examples_tpu_torch.models import moe

    moe_train = phase_moe_training(fa, qmm, llama, lora, training, moe, keep.pop("params"), card)
    log(f"phase 18 mixtral-8x7b LoRA on the capacity experts ({card}): ok in {time.monotonic() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    serverless = phase_serverless(SamplingParams, metrics["tokens"], decode)
    log(f"phase 11 serverless surface ({card}): ok in {serverless['seconds']:.1f}s: {json.dumps(serverless)}")
    rest = phase_platform_rest(SamplingParams, llama.LlamaConfig.llama2_7b().n_layers, bwd_bitwise)
    log(f"phase 14 the platform layer's rest ({card}): ok in {rest['seconds']:.1f}s: {json.dumps(rest)}")
    gc.collect()
    torch.cuda.empty_cache()
    p17 = phase_int4_and_training(fa, pa, qmm, errs, lora8["peak_gb"], card)
    gc.collect()
    torch.cuda.empty_cache()
    par = phase_parallel(llama, metrics, card)
    log(f"phase 19 tensor and data parallelism ({card}): ok in {par['seconds']:.1f}s: {json.dumps(par)}")
    serve_counts, int8_counts, train_counts = metrics["launches"], int8["launches"], train["launches"]
    wb_counts = wb["launches"]
    counts = {
        **serve_counts, **train_counts,
        **{k: int8_counts[k] for k in ("quantized_matmul", "paged_decode_int8", "kv_scatter_int8")},
        "paged_decode_writeback": wb_counts["paged_decode_writeback"],
        "paged_decode_writeback_folded": wb_counts["paged_decode_writeback_folded"],
        "paged_decode_writeback_int8": wb8["launches"]["paged_decode_writeback_int8"],
        "flash_fwd": serve_counts["flash_fwd"] + int8_counts["flash_fwd"] + train_counts["flash_fwd"],
    }
    # phase 8 adds its launches (the verify's K3 and K4 or K4-int8, the
    # drafts' decodes, prefills and fallback blocks) to every kernel it ran
    counts = {k: v + spec["launches"].get(k, 0) for k, v in counts.items()}
    # phase 9's image: the MMDiT's joint attention, once a block a forward
    counts["flash_fwd"] += workloads["text_to_image"]["k1_launches_per_image"]
    # phase 10's Mixtral bursts (bf16 K1/K2/K3/K4, int8 K1/K7/K2-int8/K3-int8)
    counts = {k: v + mixtral["launches"].get(k, 0) for k, v in counts.items()}
    # phase 11's containers: K1, K2 and K3 in the server's and the Cls's, K1
    # in 11a's and 11d's function containers; phase 14's: K1, K2 and K3 in
    # 14a's three boots, K1, K5 and K6 in 14b's three training containers
    # (marked in their rows)
    containers = {k: serverless["container_launches"].get(k, 0) + rest["container_launches"].get(k, 0)
                  for k in {*serverless["container_launches"], *rest["container_launches"]}}
    counts = {k: v + containers.get(k, 0) for k, v in counts.items()}
    # phase 12's int8 LoRA steps (K7, K1, K5, K6) and phase 13's canary
    # rounds (K1, K2, K3)
    counts = {k: v + lora8["launches"].get(k, 0) + observability["launches"].get(k, 0) for k, v in counts.items()}
    # phase 18's Mixtral LoRA steps (K1, K5, K6, K7)
    counts = {k: v + moe_train["launches"].get(k, 0) for k, v in counts.items()}
    # phase 15's fleet: K1 and K3 on the prefill replica, K2 and K3 on the
    # decode replicas, the int8 pages' K2-int8 and K3-int8
    counts = {k: v + fleet_layers["launches"].get(k, 0) for k, v in counts.items()}
    # phase 16's tiers (K1, K3, K2 and their int8 twins), the depth-4 fleet
    # and the chaos runner's tiny engines
    counts = {k: v + tiers["launches"].get(k, 0) for k, v in counts.items()}
    # phase 17's int4 serving (K1, K2, K3), QLoRA (K1, K5, K6) and
    # DreamBooth-LoRA (K1, K5, K6); K7-int4's launches are its own row's
    counts = {k: v + p17["launches"].get(k, 0) for k, v in counts.items()}
    # phase 19's ranks: 19a's burst over NCCL (K1, K2, K3), 19b's four
    # bursts at the per-shard shapes on both ranks (K1, K2, K3, K4 folded,
    # K7, K2-int8, K3-int8, K4-int8), 19c's data-parallel steps, 19d's
    # ring and 19f's TP and FSDP steps (K1, K5, K6), 19e's container (K1)
    counts = {k: v + par["launches"].get(k, 0) for k, v in counts.items()}
    # phase 20's VLM burst (K1, K2, K3); the f32 instances' launches are 20c's
    # GPT and f32 Llama training steps
    counts = {k: v + p20["launches"].get(k, 0) for k, v in counts.items()}
    counts.update({k: p20["launches"][k] for k in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")})
    log(f"launches: serving {serve_counts}, write-then-attend serving at N=8 {wb_counts}, int8 serving "
        f"{int8_counts}, int8 write-then-attend serving at N=8 {wb8['launches']}, training {train_counts}, "
        f"speculation {spec['launches']}, text-to-image K1 {workloads['text_to_image']['k1_launches_per_image']}, "
        f"mixtral {mixtral['launches']}, phase 11's containers {serverless['container_launches']}, phase 14's "
        f"containers {rest['container_launches']}, int8 LoRA "
        f"{lora8['launches']}, Mixtral LoRA {moe_train['launches']}, canary {observability['launches']}, fleet "
        f"{fleet_layers['launches']}, tiers, autoscaler "
        f"and chaos {tiers['launches']}, int4 and training {p17['launches']}, parallel {par['launches']}, phase 20 "
        f"{p20['launches']}; kernels line (phases 8-20 summed) "
        f"{counts}")
    errs["flash_fwd"] = max(errs["flash_fwd"], workloads["joint_k1"]["max_abs_err"])
    errs["quantized_matmul"] = max(errs["quantized_matmul"], mixtral["expert_k7"]["max_abs_err"])
    errs["flash_fwd"] = max(errs["flash_fwd"], serverless["functions"]["k1"]["max_abs_err"],
                            serverless["cli"]["max_abs_err"])
    rows = phase_numbers(fa, pa, counts, errs)
    for r in rows:  # the write-then-attend kernels also time their verify route (8a)
        if r["name"] in spec["verify_route"]:
            r["verify"] = spec["verify_route"][r["name"]]
        if r["name"] == "flash_fwd":  # and K1 its joint attention (9a)
            r["joint"] = workloads["joint_k1"]
        if r["name"] == "quantized_matmul":  # and K7 Mixtral's expert products (10a)
            r["expert"] = mixtral["expert_k7"]["shapes"]
        if r["name"] in containers:  # launches in phase 11's and phase 14's containers
            r["container_launches"] = containers[r["name"]]
        if r["name"] in p17["dreambooth"]["joint_bwd"]:  # and K5/K6 DreamBooth's joint attention (17d)
            r["joint"] = p17["dreambooth"]["joint_bwd"][r["name"]]
    rows.append(p17["row"])
    rows += f32_rows(fa, counts, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
