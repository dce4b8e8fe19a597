#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Local AdaAlter on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each; any failure
raises and exits non-zero. The script's budget is 600 s, half the
1,200 s it may take: the wall line gives each phase's seconds (phases_s)
and each torchrun launch's start-up and runs (launches):

  device    the card's name and power limit (nvidia-smi), torch's view of it
  build     the CUDA kernels compiled from src/repro_torch/kernels/csrc/,
            one nvcc process per source, all at once
  kernels   each kernel against its plain PyTorch version on the card, at
            the full-width Big LSTM shapes of the training paths: the fused
            update and the flat update (y to rtol 8e-3 bf16 / 1e-6 fp32 of
            the larger of |y| and the update, which is a quarter of |x|
            here; b2_local bitwise; the same check must reject an update
            with η 2% off and one that reads b2_local for b2_sync), the
            one-pass EF int8 encode per leaf and over the flat plane's two
            halves (wire and residual bitwise), and the quantize /
            dequantize pair (codes, scales and x̂ bitwise); CUDA-event times
            beside the memory-bound least time; and the sync round's
            worker mean, per leaf (beside Tensor.mean) and over the planes
  reference reduced Big LSTM in float32, lr 2, 8 steps, 2 workers, int8
            sync, per-leaf and flat, one-pass and three-pass encode: the
            card with the kernels against the CPU with their plain versions,
            same initial weights (losses to rtol 1e-4, which the CPU run
            with η 2% larger must exceed). The CPU runs of this phase,
            reference_train_families' and tp_grid's run in turn in a
            process of their own (with the script's torch thread count),
            and reference_dense in another, from the script's start,
            beside the examples, the dry-run and the build (side work:
            start_side); all end before the kernels phase. flat_eq and
            the other reference_* phases below, which time nothing, run
            there too, after this one. The launches of two and of four
            ranks start there as well: their ranks import what they run
            and wait for their phases' go (start_launch)
  flat_eq   flat = per-leaf on the card: reduced size, kernels on, a local,
            a sync and a local step; params, both B² and both residuals
            bitwise, for the one-pass and the three-pass int8 encode
  train     full-width Big LSTM (793,471 vocab, 832,198,527 parameters,
            bf16), 2 workers stacked on the card, 32 sequences of 20 tokens
            per worker, Local AdaAlter H=4, int8 wire with fused error
            feedback, kernels on, 8 steps, through train_loop, per leaf —
            with the kernels' launch counts read around exactly this run
  train_flat  the same over the flat parameter plane (--flat), 8 steps
  train_unfused  the per-leaf run with the three-pass encode
            (--unfused-sync), 4 steps: the quantize pair's launches
  profile   the per-leaf and the flat run for 4 steps each under
            torch.profiler: per step the device's busy time and idle share
            and its time by kernel
  baselines the synchronous optimizers (sgd, adagrad, adaalter): reduced
            float32 AdaAlter card against CPU (lr 2, rtol 1e-4, an η 2%
            larger on the CPU must exceed it), then each at full width
            through train_loop, R = 1, 64 sequences of 20 tokens in one
            model, 8 steps: finite losses, step 0 within 1.5 nats of ln V,
            comm_bytes_total 8 x 4 x 832,198,527, no kernel launched; warm
            step walls, tokens/s and peak memory beside the per-leaf
            local_adaalter walls (one card: no collective runs); one
            profiled AdaAlter step
  checkpoint  full-width AdaAlter 8 steps straight against 4 steps, a
            checkpoint (5 GB: bf16 params, fp32 B²) and a fresh train_loop
            resuming to 8: losses 4-7 and the final state bitwise equal,
            with the bytes on disk and the save and restore seconds; then
            reduced Big LSTM on the card, Local AdaAlter int8 with the
            kernels and the adaptive policy, per leaf and flat, resumed
            mid-window at step 5 of 9 (bitwise), and a per-leaf checkpoint
            resumed over the flat plane (fixed H, bitwise state). The
            checkpoints go to a temporary directory, removed at the end;
            the phase fails if the disk has no room for two
  instrumented  the train phase's per-leaf run with trace_out and
            metrics_out: its launch counts, 8 metrics rows (residual fields
            from the first sync round, changing only on sync rounds), the
            span counts, the replay gate, the Chrome export; step walls
            and the health probe's seconds beside the uninstrumented walls;
            peak memory under 80 GB
  reference_ssm  reduced mamba2 in float32 with ssm_pallas: logits_fn on
            the card through the SSD kernel against the CPU through its plain
            version, prefill and 8 decode steps card against CPU, and on the
            card decode by the recurrence against the kernel forward,
            position by position (all to rtol 1e-4, atol 1e-5)
  score     mamba2-370m at full width, cut to 24 of its 48 layers
            (261,344,512 parameters, bf16, ssm_pallas; 48 before the 600 s
            budget): logits_fn and loss_fn over 8 x 2048 tokens, 3 times,
            24 SSD calls a forward (the SSD counter counts wrapper calls,
            three kernel launches each); one warm forward under
            torch.profiler
  serve     full-width serve_session: batch 8, 32 new tokens, the prompt
            it replays through decode_step cut to 128 positions
            (SERVE_REPLAY, two SSD chunks of 64; serve_hybrid 192, three;
            every serve phase: a replay of 512 took ~540 decode steps a
            phase), the serving numbers timed at prompt 512 (the prefill of
            8 x 512 and 8 decode steps from position 512 over the session's
            544-slot cache); prefill and decode take the chunked and
            recurrent paths, so no SSD launch
  reference_dense  reduced qwen2-7b in float32 (2 layers, 8 heads over 2 KV
            heads of 32, QKV bias, vocab 512), card against CPU, same
            weights: logits_fn over 2 x 2560 tokens (the blockwise path, its
            last block padded), prefill then 16 decode steps, a windowed
            decode (window 64) over 96 positions (all to rtol 1e-4, atol
            1e-5); on the card the prompt replayed through decode_step
            against logits_fn position by position, a check that must
            reject queries rotated a position ahead and scores scaled 2% up
  reference_lstm_serve  reduced Big LSTM in float32: prefill's last logits
            against lstm_logits' last position on each device, prefill and
            8 decode steps card against CPU (same tolerance)
  score_dense  qwen2-7b at full width, cut to 7 of its 28 layers
            (2,721,402,880 parameters, bf16; 28 before the 600 s budget):
            logits_fn and loss_fn over 2 x 4096 tokens, 3 times, losses
            within 1.5 nats of ln V; one warm forward under torch.profiler
  serve_dense  the same qwen2-7b's serve_session as serve (batch 8, 32
            new tokens; numbers at prompt 512, the session's replay over 128
            positions): the prefill's last logits against their replay
            through decode_step, to a relative L2 of 5e-2 that a prefill one
            token short and one with queries rotated a position ahead must
            exceed; one decode step under torch.profiler
  serve_lstm  the same for full-width Big LSTM (the one-token-short fault)
  The five slice-5 phases launch none of the seven kernels: every counter
  must read 0.
  reference_moe  reduced phi3.5-moe (4 experts, top-2; with its router
            and with a zero router, where every probability ties and
            capacity drops 37.5% of the choices) and reduced
            llama4-maverick (top-1, shared expert, MoE every other layer)
            in float32, card against CPU, same weights: logits_fn, loss_fn
            and its aux loss, prefill caches, 8 decode steps after the
            prefill, the prompt replayed from a zero cache (rtol 1e-4, atol
            1e-5); top-2 gates left un-renormalised and capacity ignored
            (where the forward drops a choice) must fail it
  reference_cross  reduced llama-3.2-vision (tanh gate 0.7) and
            seamless-m4t (over 96 frames and over 2,500, where the blockwise
            path pads 572 keys) with the reference's modality stubs, the
            same checks; on the card the prompt replayed through
            decode_step with the prefill's cross (k, v) against logits_fn
            (equal on the direct path; over 2,500 frames the difference the
            padded keys make is reported); the gate ignored and a causal
            encoder must fail the card-vs-CPU check
  score_moe  phi3.5-moe at full width, 2 of its 32 layers (32 do not fit
            one 80 GB card; 4 before the 600 s budget): logits_fn, loss_fn
            over 2 x 4096 tokens
            (capacity 1,280), the share of choices capacity drops; one
            forward profiled by layer (attention, MoE, expert GEMMs)
  serve_moe  serve_session on it, batch 8, prompt 512, 32 new tokens;
            capacity drops at prefill and decode; prefill vs replay with
            capacity unbounded (128 positions, relative L2 5e-2, which a
            prefill one token short and one with un-renormalised gates must
            exceed; in float32 over the same 2 layers), the reference's
            bounded prefill vs replay reported; one decode step profiled
            by layer
  score_vlm / serve_vlm  llama-3.2-vision-11b at full width, 5 of its 40
            layers (1 of 8 cross; 10 before the 600 s budget; 1,601 image
            tokens, gate 0.7): scoring over 2
            x 4096 tokens with the reference's image stubs; serve_session
            as serve_dense (zero image embeddings, as the reference's)
  score_audio / serve_audio  seamless-m4t-large-v2 at full width, 3 + 3
            of its 24 + 24 layers (6 + 6 before the 600 s budget; vocab
            256,206) over 4,096 audio frames;
            serving as serve_dense (one fault: with as many KV heads as heads,
            rotating the queries rotates the keys too)
  The slice-6 phases launch none of the seven kernels either.
  reference_hybrid  reduced hymba (2 layers, window 64, 16 SSM heads of 32,
            state 16) in float32 with ssm_pallas, card against CPU, same
            weights, as reference_moe (the SSD kernel launched twice a
            layer, by logits_fn and loss_fn); on the card the prompt of 96
            positions replayed over a ring of 64 slots against logits_fn
            and the prefill's last logits; the SSM half dropped and the mean
            fusion replaced by a sum must fail the card-vs-CPU check, those
            and a prefill one token short the prefill-vs-replay check
  reference_train_families  reduced float32 hymba, qwen2-7b and
            phi3.5-moe through train_loop (Local AdaAlter, 2 workers, int8
            H=4, lr 2, 8 steps), the card with the kernels against the CPU
            with their plain versions: losses to rtol 1e-4, which η 2% off
            must exceed; schedule and comm bytes equal; launch counts
  score_hybrid  hymba-1.5b at full width, 4 of its 32 layers (8 before
            the 600 s budget; 1,640,820,096 counted parameters at 32, bf16,
            ssm_pallas): logits_fn and loss_fn over 2 x 4096 tokens, 8 SSD
            calls a forward (50 heads: the last 8-head
            group holds 2); one forward profiled by layer (self-attention,
            SSM, SSD kernel, MLP)
  serve_hybrid  serve_session on it, batch 8, prompt 512, 32 new (the
            1,024-token window: a 544-slot cache): prefill vs replay as
            serve_dense over 192 replayed positions (three SSD chunks, so
            the check crosses two state hand-offs; a prefill one token
            short must exceed it; the SSM half dropped and a sum fusion
            reported); no SSD launch
  train_hybrid / train_hybrid_flat  hymba at full width cut to 2 of its
            32 layers (198,555,756 counted parameters, 198,558,956 in the
            tree; 4 before the 600 s budget), bf16, 2 workers x 4
            sequences of 512 tokens, Local
            AdaAlter H=4, int8 wire, kernels on, through train_loop: 8
            steps per leaf (168 update and 84 EF launches over its 21
            leaves; then 4 steps profiled) and 8 over the flat plane (8 and
            4), whose losses must equal the per-leaf run's bit for bit
  train_ranks  the train phase's runs with one worker a rank: torchrun
            --nproc-per-node 2 (two ranks time-sharing the one card, the
            wire staged through host memory; train_loop a run, per leaf
            and flat in the one launch of two ranks, TWO_RANKS, that also
            runs the FSDP phases', serve_tp's, train_sharded's and the TP
            phases' work, the ranks re-laid out as 1 x 2 after the FSDP
            runs), 8 steps each: losses,
            schedule, comm bytes and a digest of the final state (params,
            both B², both residuals) equal to the stacked train /
            train_flat runs bit for bit, which a stacked run with η 2% off
            must fail; per rank the update and EF launches of the stacked
            run and the dequantize launches of the wire (one a 2^26-element
            chunk of every rank's row of each leaf or plane half, a round),
            round_collectives collectives a round per leaf and 1 flat, the
            int8 wire bytes a round beside the accounting's (one block's
            padding a leaf; the plane's slot padding), step walls,
            peak memory and the round's parts (encode, device to host,
            gloo, host to device, dequantize + sum); the card's used memory
            (nvidia-smi) under 80 GB. Then the synchronous AdaAlter on two
            ranks (-m repro_torch.launch.train --dist-backend gloo; 32 x 20
            each; its plan splits every leaf over the two, FSDP) against one
            model over 64 x 20, float32 parameters, lr 2
            without warm-up, 6 steps, to rtol 1e-4, which an η 2% larger
            must exceed, with the gradient mean's bytes a step
  train_hybrid_remat  train_hybrid's configuration for 4 steps with the
            plan's remat="full" (each layer group recomputed in the
            backward) and 4 without: losses and final-state digest bit for
            bit (else losses to rtol 1e-5, reported), 84 update and 42 EF
            launches, the runs' peaks and walls; one worker's forward and
            backward allocation under remat none, full and dots, which
            full must lower; the layers of hymba's 32 that would fit one
            card at the run's peak bytes a parameter (derived, not run)
  train_sharded  full-width Big LSTM with its flat plane split in two: 1
            worker x 2 shards, two gloo ranks on the card through torchrun
            (in the two-rank launch, with train_tp's runs), 32 x 20
            tokens, H=2, int8, 3
            steps (one round): equal to the stacked 1-worker flat run bit
            for bit, which the stacked run with η 2% off must fail; per
            rank rows 2, 4 and 6 launched 3, 2 and 2 x ceil((P/2)/2^26)
            times,
            one collective a round moving its sub-plane halves' codes and
            scales (round_bytes_per_shard and its padding), one params
            gather a step (its bytes and parts' ms), step walls, peak memory
  sharded_grid  reduced Big LSTM as 2 workers x 2 shards, four gloo ranks
            (the worker sub-groups' means run), int8 one-pass and
            three-pass in one launch with tp_grid's runs (train_loop a
            run), the same checks
  train_fsdp  train_ranks' synchronous AdaAlter run (the CLI; each leaf
            and its B² split over the two data ranks, FSDP) against the
            same run under the replicated plan (fsdp_axes=()) through
            train_loop(plan=...) on two gloo ranks: bit for bit; per rank
            its state bytes equal to Σ part numel x 4 from the specs, 4 P
            wire bytes a step (fsdp_step_bytes), less allocated than the
            replicated rank; step walls, the params gather's and the slice
            mean's ms, allocated and reserved GB. Its replicated run,
            train_fsdp_local's three runs and train_fsdp_moe's two run in
            the two-rank launch
  train_fsdp_local  full-width Big LSTM in bf16 under the plan
            resolve_plan gives phi3.5-moe on 2 x 1 ranks (no worker axes,
            FSDP over data, remat full): one-model Local AdaAlter, int8
            wire with the kernels, H=2, 2 steps (each syncs), 64 x 20, two
            gloo ranks: bit for bit the replicated plan's run, which the
            FSDP run with η 2% off must fail; per rank row 3 launched 2 x 11
            times a step and nothing else, state bytes from the specs,
            fsdp_step_bytes a step (bf16 parts of the params)
  train_fsdp_moe  phi3.5-moe at full width cut to 1 of its 32 layers
            (1,562,980,352 parameters, bf16), synchronous AdaAlter under
            its own plan (FSDP over data, remat full), 2 steps over 8 x
            512 tokens on two gloo ranks, the batch's rows routed as one
            batch: bit for bit the same run under remat none (each
            recomputed group routes as the forward did, though autograd
            runs the backward on a thread of its own); per rank and
            policy the step walls, the gather's and slice mean's ms,
            allocated and reserved GB; state and wire bytes from the
            specs; no kernel launched
  serve_tp  full-width qwen2-7b (2 of 28 layers, bf16; 4 before the 600 s
            budget) served on 1 x 2 gloo
            ranks with tensor parallelism over model (build_serve_programs
            and serve_session with a group; the KV cache split along its
            sequence): the one-rank run's weights, each rank its parts; a
            rank's weight bytes the specs' (Σ part numel x 2), its cache
            half the one-rank cache; the prefill's last logits at 128
            against the one-rank prefill's to relative L2 5e-2, which rank
            1 dropping its wo partials must exceed; prefill timed at 512,
            4 decode steps from 512 (TP collectives and bytes a step,
            gloo's share); a session (batch 8, 8 replayed positions, 8
            new) whose prefill vs replay holds 5e-2, which a replay with
            each rank scoring its slots as its neighbour's must exceed
  train_tp  qwen2-7b at full width cut to 2 of 28 layers (1,556,113,920
            parameters, bf16), 1 worker x 2 TP shards, Local AdaAlter int8
            + kernels, 4 x 512 tokens, H=2, 4 steps, lr 0.5 without
            warm-up, under remat full and save_tp: losses against the
            one-rank run to rtol 4e-3, which η 2% off must exceed; save_tp
            bit for bit full with fewer TP collectives a step; a rank's
            state bytes equal Σ part numel x 18 from the specs; rows 1, 3
            and 6 launched; walls, TP collectives and bytes a step, peak GB
  tp_grid  reduced Big LSTM and qwen2-7b in float32 on 2 x 2 ranks (2
            workers x 2 TP shards), lr 2, 8 steps: losses against the
            stacked card run and the CPU run to rtol 1e-4, which the CPU
            run with η 2% larger must exceed
  biglstm_tp_meta  full-width Big LSTM at model = 2 reckoned on the meta
            device: a rank's parameter and state bytes from the specs; its
            odd vocabulary (793,471) leaves embed, head_w and head_b whole
  serve_tp_families  in serve_tp's launch, after it: mamba2-370m (6 of
            48 layers, 12 before the 600 s budget; and in float32, its
            scoring forward only), hymba-1.5b
            (2 of 32), phi3.5-moe (1 of 32, bf16 with the one-rank runs
            replaying the TP run's routing, flips counted; and float32,
            its scoring forward only, unpinned), llama-3.2-vision-11b (5
            of 40, gate 0.7, image stubs) and seamless-m4t (1 + 1 of 24 +
            24, audio stubs) at full width on 1 x 2 gloo ranks: a rank's weight and cache bytes
            the specs' parts; a scoring forward of 1 x 2048 tokens through
            logits_fn (ssm_pallas: the SSD kernel at 16 of mamba2's 32
            heads and 25 of hymba's 50 a rank, one call a layer, counted),
            a prefill at batch 8 and prompt 512 and 8 decode steps from a
            seeded random cache (each rank its part), each against rank
            0's one-rank run of the same weights to relative L2 5e-2 (1e-4
            for mamba2 in float32), which rank 1 dropping its out_proj /
            experts' / wo partials must exceed on the scoring forward and
            on a decode step; walls and TP collectives
  train_tp_families  in train_tp's launch: hymba-1.5b at 2 of 32 layers
            (bf16, lr 0.5, remat full and save_tp) and phi3.5-moe at 1 of
            32 (bf16, lr 0.2, the one-rank runs replaying the TP run's
            routing; and float32, lr 0.1), 1 worker x 2 TP shards, Local
            AdaAlter int8 + kernels, 4 x 512 tokens, H=2, 4 steps: losses
            against the one-rank run to rtol 2e-4, which η 2% off must
            exceed; save_tp bit for bit full; state bytes from the specs;
            rows 1 and 3 a launch a leaf a step and two a leaf a round (the
            experts' parts among them), row 6 launched
  tp_grid also runs reduced mamba2, hymba, phi3.5-moe, llama-3.2-vision
            and seamless-m4t, 4 steps each, to rtol 3e-5
  dryrun   (slice 14, first, before anything runs) the package's dry-run
            of five of the runs below on the meta device (the full
            phase's Big LSTM local and sync step, score_dense's forward,
            a serve_dense decode step, a train_fsdp_tp qwen2-7b rank from
            a DryGroup at 2 x 2, a serve_tp decode step at 1 x 2);
            dryrun_card / dryrun_card_dense hold each one-card call
            against it: the walk on the card sees the same ops, FLOPs,
            bytes and kernel launches, the resident bytes equal
            memory_allocated's rise, the peak within 10% of
            max_memory_allocated, the measured wall beside the roofline;
            train_fsdp_tp and serve_tp hold their collectives a step, and
            a rank's state and weight bytes, to it
  examples  the four examples of examples/torch/ on the card, started
            together before the dry-run, the build and the reference phase
            (which time nothing) and waited for before the kernels phase:
            quickstart and serve_batched at their defaults,
            reproduce_paper at 16 steps (30 before the 600 s budget; its
            H = 16 run syncs once), train_100m for 4 steps and then
            resumed from its checkpoint to 8 (10 and 20 before)
  fsdp_tp_meta  the reckoning (the package's dry-run), before the slice-13
            launch: a rank's weights at rest (tiles) and TP parts for
            serve_fsdp_tp, a rank's state under FSDP + TP and under the
            data-replicated TP run for train_fsdp_tp
  serve_fsdp_tp  llama3-405b at full width cut to 1 of 126 layers
            (7,390,412,800 parameters, bf16) on 2 x 2 gloo ranks under
            serve_plan (weight_gather_serving: each rank's tiles at rest,
            a layer group's TP parts gathered over data as it runs): a
            prefill of 4 x 512 and 2 decode steps (the second reads the
            cache the first wrote), logits and caches bit
            for bit the same grid's TP-only serving (freed before); a
            rank's weight bytes the specs' tiles, the gather's bytes and
            seconds a forward, prefill and decode ms, peak GB a rank
  train_fsdp_tp  on 2 x 2 ranks, bf16, 4 x 512 tokens: qwen2-7b (1 of
            28 layers; 4 before the 600 s budget) under synchronous
            AdaAlter, 3 steps, bit for bit the
            data-replicated TP run; phi3.5-moe (1 of 32) under its plan
            (one-model Local AdaAlter, int8 + kernels, H=2), 2 steps, row 3
            launched on its tiles (2 a leaf a round); state bytes from the
            specs, step walls, TP and FSDP collectives a step
  tp_grid_fsdp_tp  tp_grid's extension, reduced float32 on the same
            ranks: llama3-405b under synchronous AdaAlter with FSDP + TP
            (lr 2, 8 steps) against its one-device card and CPU runs to
            rtol 1e-4, which η 2% off must exceed; seq_parallel = none bit
            for bit (qwen2-7b, mamba2), remat "dots" = "none" under TP
            (hymba), phi3.5-moe's FSDP + TP = data-replicated bit for bit;
            a flat checkpoint restored into a TP per-leaf run (its state
            the stacked per-leaf restore's); the ranks laid out as 4 x 1
            for gathered-weight serving at model = 1 (reduced llama3-405b),
            bit for bit the replicated serving, to rtol 1e-4 of one CPU
            device
  train_pods  (slice 15, in the same launch, the group re-split onto pod
            grids) workers as pods under phi3.5-moe's plan (local_axes=
            ('pod',), FSDP over a pod's data ranks): mamba2-370m at full
            width, 12 of 48 layers (24 before the 600 s budget), bf16, on
            2 pods x 2 data ranks, 8 x 512 tokens, int8 + kernels, H = 2,
            3 steps (4 before), bit for bit its
            data-replicated run; each rank held to the dry-run's
            prediction made first (in the dryrun phase, a DryGroup on the
            pod grid): collectives and bytes a run and a round exact (the
            round the whole-block wire of its tiles), rows 1, 3 and 6
            launched as predicted, peak within 10%; the round's parts
            (encode, d2h, gloo, h2d, dequantize + sum); the flat twin
            (3 layers, float32; 6 before) bit for bit its per-leaf run,
            rows 2, 4
            and 6 launched; reduced phi3.5-moe in float32 under its plan
            on 2 x 2 x 1 and 2 x 1 x 2 against the stacked CPU run to rtol
            1e-4, which η 2% off must exceed

The instrumented phase's trace carries the steps' cost tables (the
package's meta walk, priced on the H100: meta["hlo_cost"]), their FLOPs
and bytes equal to a fresh meta walk's; the replay priced from them is
reported, and the gate holds the trace without them.

The kernels phase also holds the SSD chunk scan's warp-level 3xTF32
product helper alone against a float64 product, then the SSD kernels
against their plain version at the scoring shape (fp32 and bf16 inputs)
and at a 32k-token sequence, with each of the three kernels' device time
and launch geometry, at the CPU tests' shapes of 2 and 4 heads (a part
of one 8-head group) and at hymba's scoring shape (50 heads, the last
group of 2), and counts the TF32 tensor-core instructions in the built
SSD kernels (cuobjdump -sass). It holds the update and EF kernels (per
leaf and flat) against their plain versions at train_hybrid's shapes too:
each distinct stacked leaf of the 8-layer hymba tree in bf16 (B² in fp32)
and that tree's plane with its bf16 row sidecars, the flat update and
both flat EF halves on each sub-plane of train_sharded's 2-shard plane
with its shard's sidecar rows, and row 3 on every part shape a rank of
train_fsdp_local encodes (unstacked, bf16 params and fp32 B²), the
largest timed, and rows 1, 3 and 6 on every part shape a train_tp or
train_tp_families rank updates, encodes and decodes (check_tp_parts: the
expert part (1, 1, 8, 4096, 6400) among them), and the SSD at a TP rank's
heads (1, 32, 64, 16, 64), N 128 and (1, 32, 64, 25, 64), N 16, and
row 3 on every tile shape train_fsdp_tp's phi3.5-moe ranks encode in
place (fsdp_tp_tiles), and rows 1, 3 and 6 on every tile shape of a
train_pods rank, rows 2 and 4 on its flat twin's sub-planes
(pod_tiles). Then

  regress   the port's bench-regression gate (python -m
            repro_torch.obs.regress) on this run's own rows, one a phase
            line (its kernels' launches, sync steps, collective and byte
            counts, walls): the rows as baseline and as fresh run (exit 0),
            one launch count one higher (exit 1, that field named in the
            report), every wall doubled (exit 0), one row dropped (exit
            1, "missing"); nothing under benchmarks/ is read

the script's wall (with phases_s and launches),
the kernels summary
line (each kernel's launches on its main path, and by phase), the
nvidia-smi line, and the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# the card's data-sheet rates (repro_torch.hardware.H100: HBM bytes/s, the
# dense bf16 / TF32 / fp32 peaks), set by main() once the package is found
H100 = None
TRAIN_STEPS = 8
# the synchronous AdaAlter on two ranks (train_ranks) and its FSDP
# comparison (train_fsdp): at full width an η 2% larger moves the losses
# 3.2e-4 by step 5 (under 1e-4 before it; an H100), so 6 steps keep the
# η check
RANKS_BASELINE_STEPS = 6
SSD_TOL = 1e-4                 # SSD kernel vs plain, fp32 and bf16 inputs
MMA_TOL = 1e-5                 # 3xTF32 product helper vs float64, of Σ|a||b|
SSD_KERNELS = ("ssd_chunk_states", "ssd_state_pass", "ssd_chunk_output")
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5   # reduced models in float32
# the SSD at the CPU tests' shapes (b, nz, c, nh, hd, n): 2 and 4 heads, a
# part of one 8-head group (tests/test_torch_ssm.py SSD_SHAPES)
SSD_PARTIAL_GROUP_SHAPES = [(1, 2, 8, 2, 16, 8), (2, 4, 16, 4, 32, 16),
                            (2, 3, 32, 2, 64, 32), (1, 8, 64, 2, 64, 128)]
# full width in bf16: the prefill's last logits against the replay's,
# relative L2 over the batch's logits. The two paths round in bf16 at other
# places over 28 layers (qwen2-7b: 0.017 measured on an H100); a prefill
# one token short (0.66) or with queries rotated a position ahead (0.21)
# must exceed it
SERVE_REL_L2 = 5e-2
CROSS_GATE = 0.7               # the VLM's tanh gate in the checks (0 at init)
# phi3.5-moe's 32 layers hold 83.75 GB of bf16 weights, more than one 80 GB
# card: the MoE phases run its first 2 at full width (4 before the script
# was cut to its 600 s budget; its float32 prefill-vs-replay check too)
MOE_LAYERS = 2
# depth cuts that keep the script within its 600 s budget, every check
# kept (the cut before it in brackets): llama-3.2-vision at 5 of its 40
# layers (10; 1 of 8 cross-attention groups), seamless-m4t at 3 + 3 of
# 24 + 24 (6 + 6), hymba scored and served at 4 of 32 (8), qwen2-7b scored
# and served at 7 of 28 (28), mamba2-370m at 24 of 48 (48)
DEPTH_CUTS = {"llama-3.2-vision-11b": {"n_layers": 5},
              "seamless-m4t-large-v2": {"n_layers": 3,
                                        "n_encoder_layers": 3},
              "hymba-1.5b": {"n_layers": 4},
              "qwen2-7b": {"n_layers": 7},
              "mamba2-370m": {"n_layers": 24}}
SERVE_PROMPT = 512             # the serve phases' prompt length
# the prompt each serve phase's serve_session replays through decode_step
# (the serving numbers are timed at SERVE_PROMPT): two of mamba2's 64-token
# SSD chunks; hymba's, whose prefill-vs-replay check must cross the
# chunked prefill's state hand-offs, three (two hand-offs)
SERVE_REPLAY = 128
HYBRID_SERVE_REPLAY = 192
HYMBA_TRAIN_LAYERS = 2         # hymba-1.5b trained at full width, 2 of 32
# train_sharded / sharded_grid: H = 2, one round (step 1) and a warm local
# step after it (two rounds took the whole script past 650 s)
SHARDED_STEPS = 3
SHARDED_H = 2


def free_card() -> None:
    """Give the freed weights back to the card and restart the peak."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


T_START = time.perf_counter()
# every phase line emitted so far, in order (the regress phase's rows and
# the wall line's phases_s are made from them)
PHASE_LINES = []


def emit(obj) -> None:
    """One JSON line; a phase's line also gives the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
        PHASE_LINES.append(obj)
    print(json.dumps(obj), flush=True)


def phases_s() -> dict:
    """Each phase's seconds: its line's ``t_s`` less the previous line's
    (the first counts from the script's start; a name seen twice adds)."""
    out, last = {}, 0.0
    for line in PHASE_LINES:
        out[line["phase"]] = out.get(line["phase"], 0.0) + line["t_s"] - last
        last = line["t_s"]
    return out


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def pin_routing(record=None, replay=None):
    """The MoE routers' top-k choices appended to the list ``record`` (a
    call's (T, k) expert ids, on the CPU), or taken from ``replay`` in call
    order, the gates then this run's probabilities at those experts: two
    runs that round otherwise, one of them replaying the other's record,
    route every token alike, so a near tie that the rounding flips cannot
    move a check. A replay must use every choice recorded."""
    import torch
    from repro_torch.models import moe as moe_mod
    real = moe_mod._top_k
    calls = None if replay is None else iter(replay)

    def top_k(probs, k):
        if calls is None:
            vals, idx = real(probs, k)
            record.append(idx.cpu())
            return vals, idx
        idx = next(calls, None)
        require(idx is not None and idx.shape == (probs.shape[0], k),
                "pin_routing: no recorded call, or one of other shape, "
                f"for {probs.shape[0]} tokens")
        idx = idx.to(probs.device)
        return torch.gather(probs, -1, idx), idx
    moe_mod._top_k = top_k
    try:
        yield
        require(calls is None or next(calls, None) is None,
                "pin_routing: the replay left recorded calls unused")
    finally:
        moe_mod._top_k = real


def choice_flips(a, b) -> int:
    """The (call, token) pairs whose sets of chosen experts differ between
    two records of the same calls."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one call, by CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bitwise_equal(a, b) -> bool:
    import torch
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}[a.dtype]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(view), b.view(view)))


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def max_rel(a, b) -> float:
    """The largest relative difference between two loss curves."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def update_agrees(y, y_ref, x, rtol) -> bool:
    """y within ``rtol`` (a number, or a tensor that broadcasts) of
    ``y_ref``, measured against the larger of |y_ref| and the update
    |x − y_ref|: where the update nearly cancels x, the error is held at the
    update's own scale. No absolute floor."""
    import torch
    yf, rf = y.float(), y_ref.float()
    scale = torch.maximum(rf.abs(), (x.float() - rf).abs())
    return bool(((yf - rf).abs() <= rtol * scale).all())


def check_update(gen, shape, dtype, timed=True):
    """Fused update kernel vs its plain version on one stacked leaf.

    The inputs make the update a quarter of |x| (η = 0.5, g ~ N(0, 1),
    rsqrt(b2_sync + 3) ≈ 0.47), so y's tolerance sees it; the check must
    also reject two wrong updates: η 2% too large, and b2_local read in
    place of b2_sync."""
    import torch
    from repro_torch.kernels import adaalter_update as au
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    bs = 1.0 + torch.rand(shape, generator=gen, device="cuda")
    bl = bs + torch.rand(shape, generator=gen, device="cuda")
    scalars = au.update_scalars(0.5, 3.0, "cuda")
    y, b2 = au.fused_update(x, g, bs, bl, scalars)
    y_ref, b2_ref = au.fused_update_plain(x, g, bs, bl, scalars)
    torch.cuda.synchronize()
    rtol = 8e-3 if dtype == torch.bfloat16 else 1e-6
    max_err = float((y.float() - y_ref.float()).abs().max())
    require(update_agrees(y, y_ref, x, rtol),
            f"update y off its plain version ({dtype}, max {max_err})")
    require(bitwise_equal(b2, b2_ref), f"update b2_local not bitwise ({dtype})")
    del y, b2, b2_ref
    wrong = {
        "eta_2pct_high": au.fused_update_plain(
            x, g, bs, bl, au.update_scalars(0.5 * 1.02, 3.0, "cuda"))[0],
        "b2_local_for_b2_sync": au.fused_update_plain(x, g, bl, bl,
                                                      scalars)[0]}
    for what, y_bad in wrong.items():
        require(not update_agrees(y_bad, y_ref, x, rtol),
                f"the update check accepts a wrong update ({what}, {dtype})")
    del wrong, y_bad
    out = dict(dtype=str(dtype).replace("torch.", ""), shape=list(shape),
               max_abs_err=max_err, rejects_wrong_updates=True)
    if timed:
        nbytes = x.numel() * (3 * x.element_size() + 3 * 4)
        out.update(
            ms=cuda_ms(lambda: au.fused_update(x, g, bs, bl, scalars)),
            plain_ms=cuda_ms(lambda: au.fused_update_plain(x, g, bs, bl,
                                                           scalars)),
            bytes=nbytes, bound_ms=1e3 * nbytes / H100.hbm_bw)
    return out


def check_ef(gen, shape, dtype, clamp, timed=True, batch_ndim=1):
    """One-pass EF encode kernel vs its plain version on one stacked leaf
    (``batch_ndim`` 0: an unstacked leaf, or a rank's part of one, encoded
    whole): wire and residual, and the int8 codes and scales it writes
    beside the wire for a run with one worker a rank, bitwise."""
    import torch
    from repro_torch.kernels import sync_fused as sf
    stripe = min(4096, math.prod(shape) // 4)   # a quarter of a small leaf
    if clamp:      # accumulator payload: B² around 1, a residual that
        # drives a stripe of it negative so the clamp fires
        x = (1.0 + torch.rand(shape, generator=gen, device="cuda")).to(dtype)
        e = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        e.view(-1)[:stripe] = -4.0
    else:
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(dtype)
        e = torch.randn(shape, generator=gen, device="cuda") * 1e-4
    x.view(-1)[stripe:stripe + 512] = 0      # all-zero blocks
    e.view(-1)[stripe:stripe + 512] = 0
    w_ref, r_ref, (q_ref, s_ref) = sf.fused_ef_leaf_plain(
        x, e, batch_ndim=batch_ndim, clamp_nonneg=clamp, codes=True)
    e_k = e.clone()
    w, r, (q, sc) = sf.fused_ef_leaf(x, e_k, batch_ndim=batch_ndim,
                                     clamp_nonneg=clamp, codes=True)
    torch.cuda.synchronize()
    require(r.data_ptr() == e_k.data_ptr(), "EF residual not written in place")
    require(bitwise_equal(w, w_ref), f"EF wire not bitwise ({dtype}, {clamp})")
    require(bitwise_equal(r, r_ref), f"EF residual not bitwise ({dtype}, {clamp})")
    require(bitwise_equal(q, q_ref) and bitwise_equal(sc, s_ref),
            f"EF codes or scales not bitwise ({dtype}, {clamp})")
    out = dict(dtype=str(dtype).replace("torch.", ""), shape=list(shape),
               clamp_nonneg=clamp, batch_ndim=batch_ndim,
               max_abs_err=max(float((w.float() - w_ref.float()).abs().max()),
                               float((r - r_ref).abs().max()),
                               float((sc - s_ref).abs().max())))
    del q, sc, q_ref, s_ref
    if timed:
        del w_ref, r_ref
        nbytes = x.numel() * (2 * x.element_size() + 2 * 4)
        out.update(
            ms=cuda_ms(lambda: sf.fused_ef_leaf(x, e_k, batch_ndim=batch_ndim,
                                                clamp_nonneg=clamp)),
            plain_ms=cuda_ms(lambda: sf.fused_ef_leaf_plain(
                x, e, batch_ndim=batch_ndim, clamp_nonneg=clamp)),
            bytes=nbytes, bound_ms=1e3 * nbytes / H100.hbm_bw,
            # with the codes and scales written (a rank's wire)
            ms_with_codes=cuda_ms(lambda: sf.fused_ef_leaf(
                x, e_k, batch_ndim=batch_ndim, clamp_nonneg=clamp,
                codes=True)),
            bound_ms_with_codes=1e3 * (nbytes + x.numel() * (1 + 4 / 256))
            / H100.hbm_bw)
    return out


def full_plane(cfg, workers: int, shards: int = 1):
    """The FlatSpace of ``cfg``'s stacked parameters, as training builds
    it (split into ``shards`` sub-planes), from shapes alone (meta tensors:
    no memory)."""
    from repro_torch.core.flatspace import FlatSpace
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    meta = build_model(cfg).init(None, "meta")
    return FlatSpace.build(tree_map(
        lambda x: x[None].expand((workers,) + x.shape), meta), batch_ndim=1,
        shards=shards)


def check_tree_kernels(gen, cfg, workers: int) -> dict:
    """Rows 1-4 against their plain versions at the shapes that training
    ``cfg`` gives them: the fused update and the EF encode at each distinct
    stacked leaf (the update and the params' wire in the leaf's dtype, B²'s
    wire in fp32 with its clamp), the flat update and both flat EF halves
    over the tree's plane with its own row sidecars. Untimed."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    out, seen = {"leaves": []}, set()
    for m in leaves(build_model(cfg).init(None, "meta")):
        shape, dtype = (workers,) + tuple(m.shape), m.dtype
        if (shape, dtype) in seen:
            continue
        seen.add((shape, dtype))
        out["leaves"].append(dict(
            shape=list(shape), dtype=str(dtype).replace("torch.", ""),
            update=check_update(gen, shape, dtype, timed=False)[
                "max_abs_err"],
            ef_params=check_ef(gen, shape, dtype, False, timed=False)[
                "max_abs_err"],
            ef_b2=check_ef(gen, shape, torch.float32, True, timed=False)[
                "max_abs_err"]))
        torch.cuda.empty_cache()
    fs = full_plane(cfg, workers)
    out["plane"] = {"plane_size": fs.plane_size, "real": fs.n_real,
                    "slots": fs.n_leaves}
    out["flat_update"] = check_flat_update(gen, fs, timed=False)
    torch.cuda.empty_cache()
    out["flat_ef"] = [check_flat_ef(gen, fs, half, timed=False)
                      for half in ("params", "b2")]
    torch.cuda.empty_cache()
    return out


def check_flat_update(gen, fs, timed=True, shard=None):
    """Flat update kernel vs its plain version on the full-width planes
    (R, P) with the plane's own bf16 row sidecar, or on one rank's
    sub-plane ``shard`` (1, P / S) with its shard's rows (a sharded run).
    The plain version is compared one worker row at a time (it is
    elementwise, and the full planes' temporaries would not fit beside the
    kernel's); the same check must reject the two wrong updates of
    :func:`check_update`."""
    import torch
    from repro_torch.kernels import adaalter_update as au
    shape = fs.batch_shape + (fs.plane_size,)
    if shard is not None:
        shape = (1, fs.shard_size)
    rows = torch.from_numpy(fs.round16_rows(au.LANES, shard)).cuda()
    x = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda")
    bs = 1.0 + torch.rand(shape, generator=gen, device="cuda")
    bl = bs + torch.rand(shape, generator=gen, device="cuda")
    scalars = au.update_scalars(0.5, 3.0, "cuda")
    y, b2 = au.flat_fused_update(x, g, bs, bl, scalars, rows)
    torch.cuda.synchronize()
    rtol = torch.where(rows > 0, 8e-3, 1e-6)          # bf16 rows / fp32 rows
    by_row = lambda t: t.reshape(-1, au.LANES)        # noqa: E731
    err = 0.0
    for w in range(shape[0]):
        xw, gw, bsw, blw = (t[w:w + 1] for t in (x, g, bs, bl))
        y_ref, b2_ref = au.flat_fused_update_plain(xw, gw, bsw, blw, scalars,
                                                   rows)
        err = max(err, max_abs_err(y[w:w + 1], y_ref))
        require(update_agrees(by_row(y[w:w + 1]), by_row(y_ref), by_row(xw),
                              rtol), f"flat update y off its plain version "
                f"(worker {w}, max {err})")
        require(bitwise_equal(b2[w:w + 1], b2_ref),
                f"flat update b2_local not bitwise (worker {w})")
        del b2_ref
        wrong = {"eta_2pct_high": (xw, gw, bsw, blw, au.update_scalars(
                     0.5 * 1.02, 3.0, "cuda"), rows),
                 "b2_local_for_b2_sync": (xw, gw, blw, blw, scalars, rows)}
        for what, args in wrong.items():
            y_bad = au.flat_fused_update_plain(*args)[0]
            require(not update_agrees(by_row(y_bad), by_row(y_ref), by_row(xw),
                                      rtol),
                    f"the flat update check accepts a wrong update ({what})")
            del y_bad
        del y_ref
    del y, b2
    torch.cuda.empty_cache()
    nbytes = x.numel() * 6 * 4
    out = dict(shape=list(shape), shard=shard, bf16_rows=float(rows.mean()),
               max_abs_err=err, rejects_wrong_updates=True)
    if not timed:
        return out
    out["ms"] = cuda_ms(lambda: au.flat_fused_update(x, g, bs, bl, scalars,
                                                     rows))
    torch.cuda.empty_cache()
    out.update(plain_ms=cuda_ms(lambda: au.flat_fused_update_plain(
        x, g, bs, bl, scalars, rows), reps=3, warmup=1),
        bytes=nbytes, bound_ms=1e3 * nbytes / H100.hbm_bw)
    return out


def check_flat_ef(gen, fs, half, timed=True, shard=None):
    """Flat EF kernel vs its plain version on one half of the full-width
    ``[params ‖ B²]`` payload, (R, P) fp32 with that half's sidecars, or on
    one rank's sub-plane ``shard`` (1, P / S) with its shard's: the params
    half rounds the wire through bf16 on its 16-bit slots and clamps at
    float32-min; the B² half clamps at 0 and does not round. Wire and
    residual bitwise, compared one worker row at a time."""
    import torch
    from repro_torch.kernels import sync_fused as sf
    from repro_torch.kernels.ref import F32_MIN
    shape = fs.batch_shape + (fs.plane_size,)
    if shard is not None:
        shape = (1, fs.shard_size)
    nb_row = shape[-1] // sf.BLOCK
    if half == "params":
        rnd = torch.from_numpy(fs.round16_rows(sf.BLOCK, shard)).cuda()
        low = torch.full_like(rnd, F32_MIN)
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(
            torch.bfloat16).float()               # bf16 values, as trained
        e = torch.randn(shape, generator=gen, device="cuda") * 1e-4
    else:           # B² around 1, a residual stripe that the clamp catches
        rnd = torch.zeros((nb_row, 1), device="cuda")
        low = torch.zeros_like(rnd)
        x = 1.0 + torch.rand(shape, generator=gen, device="cuda")
        e = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        e.view(-1)[:4096] = -4.0
    x.view(-1)[4096:4096 + 512] = 0                # two all-zero blocks
    e.view(-1)[4096:4096 + 512] = 0
    x2d, e2d = x.view(-1, sf.BLOCK), e.view(-1, sf.BLOCK)
    e_k = e2d.clone()
    wire, r, (q, sc) = sf.flat_ef_blocks(x2d, e_k, rnd, low, codes=True)
    torch.cuda.synchronize()
    require(r.data_ptr() == e_k.data_ptr(), "flat EF residual not in place")
    err = 0.0
    for w in range(shape[0]):
        rows = slice(w * nb_row, (w + 1) * nb_row)
        w_ref, r_ref, (q_ref, s_ref) = sf.flat_ef_blocks_plain(
            x2d[rows], e2d[rows], rnd, low, codes=True)
        require(bitwise_equal(wire[rows], w_ref),
                f"flat EF wire not bitwise ({half}, worker {w})")
        require(bitwise_equal(r[rows], r_ref),
                f"flat EF residual not bitwise ({half}, worker {w})")
        require(bitwise_equal(q[rows], q_ref)
                and bitwise_equal(sc[rows], s_ref),
                f"flat EF codes or scales not bitwise ({half}, worker {w})")
        err = max(err, max_abs_err(wire[rows], w_ref),
                  max_abs_err(r[rows], r_ref), max_abs_err(sc[rows], s_ref))
        del w_ref, r_ref, q_ref, s_ref
    del wire, r, q, sc
    torch.cuda.empty_cache()
    nbytes = x.numel() * 4 * 4
    out = dict(half=half, shape=list(shape), shard=shard, max_abs_err=err)
    if not timed:
        return out
    out["ms"] = cuda_ms(lambda: sf.flat_ef_blocks(x2d, e_k, rnd, low))
    del e_k
    torch.cuda.empty_cache()
    out.update(plain_ms=cuda_ms(lambda: sf.flat_ef_blocks_plain(
        x2d, e2d, rnd, low), reps=3, warmup=1),
        bytes=nbytes, bound_ms=1e3 * nbytes / H100.hbm_bw)
    return out


def check_quantize(gen, shape):
    """Quantize and dequantize kernels vs their plain versions on one
    stacked leaf's blocks: codes, scales and x̂ bitwise (an all-zero block,
    and -0 and tiny negative inputs whose codes round to -0, included).
    ``torch.mul`` of the codes and the scales (type promotion to fp32) is
    the one PyTorch call that computes x̂."""
    import torch
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.ref import (dequantize_blocks_ref,
                                         quantize_blocks_ref)
    x = torch.randn(shape, generator=gen, device="cuda") * 0.05
    flat = x.view(-1)
    flat[4096:4096 + 256] = 0                      # an all-zero block
    flat[8192:8192 + 8] = -0.0
    flat[8200:8200 + 8] = -1e-9                    # codes that round to -0
    x2d = x.view(-1, qz.BLOCK)
    q, s = qz.quantize_blocks(x2d)
    q_ref, s_ref = quantize_blocks_ref(x2d)
    y = qz.dequantize_blocks(q, s)
    y_ref = dequantize_blocks_ref(q, s)
    torch.cuda.synchronize()
    require(bitwise_equal(q, q_ref), "quantize codes not bitwise")
    require(bitwise_equal(s, s_ref), "quantize scales not bitwise")
    require(bitwise_equal(y, y_ref), "dequantize not bitwise")
    require(not bool((torch.signbit(y) & (y == 0)).any()),
            "dequantize wrote a -0")
    lib = torch.mul(q, s)
    require(bitwise_equal(lib, y_ref), "torch.mul(q, scales) is not x̂")
    err = dict(quantize=max(max_abs_err(q, q_ref), max_abs_err(s, s_ref)),
               dequantize=max_abs_err(y, y_ref))
    del q_ref, s_ref, y_ref, lib, y
    n, nb = x.numel(), x2d.shape[0]
    qbytes = n * 4 + n + nb * 4
    dbytes = n + nb * 4 + n * 4
    return dict(
        shape=list(shape), max_abs_err=err,
        quantize=dict(ms=cuda_ms(lambda: qz.quantize_blocks(x2d)),
                      plain_ms=cuda_ms(lambda: quantize_blocks_ref(x2d)),
                      bytes=qbytes, bound_ms=1e3 * qbytes / H100.hbm_bw,
                      library_ms=None),
        dequantize=dict(ms=cuda_ms(lambda: qz.dequantize_blocks(q, s)),
                        plain_ms=cuda_ms(lambda: dequantize_blocks_ref(q, s)),
                        bytes=dbytes, bound_ms=1e3 * dbytes / H100.hbm_bw,
                        library_ms=cuda_ms(lambda: torch.mul(q, s))))


def check_subplane_codes(gen, n: int) -> dict:
    """Rows 5 and 6 as a sharded run gives them one sub-plane half of ``n``
    elements: the three-pass encode's quantize and dequantize of the whole
    (n / 256, 256) half, and the sync mean's decode of a rank's codes a
    ``MEAN_CHUNK`` at a time through ``quantize.dequantize_range`` (a
    shorter last chunk included), each bitwise against its plain version.
    Untimed."""
    import torch
    from repro_torch.core.comm import MEAN_CHUNK
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.ref import (dequantize_blocks_ref,
                                         quantize_blocks_ref)
    x = torch.randn((n // qz.BLOCK, qz.BLOCK), generator=gen,
                    device="cuda") * 0.05
    flat = x.view(-1)
    flat[4096:4096 + 256] = 0                      # an all-zero block
    flat[8192:8192 + 8] = -0.0
    flat[8200:8200 + 8] = -1e-9                    # codes that round to -0
    q, s = qz.quantize_blocks(x)
    q_ref, s_ref = quantize_blocks_ref(x)
    require(bitwise_equal(q, q_ref) and bitwise_equal(s, s_ref),
            f"quantize not bitwise on a {n}-element sub-plane half")
    err = dict(quantize=max(max_abs_err(q, q_ref), max_abs_err(s, s_ref)))
    del x, flat, q_ref, s_ref
    y, y_ref = qz.dequantize_blocks(q, s), dequantize_blocks_ref(q, s)
    require(bitwise_equal(y, y_ref),
            f"dequantize not bitwise on a {n}-element sub-plane half")
    err["dequantize"] = max_abs_err(y, y_ref)
    del y, y_ref
    chunks = []
    for a in range(0, n, MEAN_CHUNK):
        b = min(n, a + MEAN_CHUNK)
        y = qz.dequantize_range(q, s, a, b)
        y_ref = dequantize_blocks_ref(q[a // qz.BLOCK:b // qz.BLOCK],
                                      s[a // qz.BLOCK:b // qz.BLOCK])
        require(bitwise_equal(y, y_ref.view(-1)),
                f"dequantize of elements {a}:{b} of {n} not bitwise")
        err["dequantize"] = max(err["dequantize"],
                                max_abs_err(y, y_ref.view(-1)))
        chunks.append(b - a)
        del y, y_ref
    del q, s
    torch.cuda.empty_cache()
    return dict(elements=n, decode_chunks=chunks, max_abs_err=err)


def time_sync_mean(gen, cfg, fs):
    """CUDA-event times of the sync round's worker mean at full width: the
    ordered fp32 sum of ``core.comm.worker_mean_`` over the stacked
    per-leaf params (bf16) and B² (fp32), beside ``Tensor.mean`` on the same
    trees (what slice 1 took; it rounds differently from the reference at
    3 and more workers), timed in turns; and ``mean_planes`` over the flat
    path's two fp32 payload planes."""
    import torch
    from repro_torch.core.flatspace import mean_planes
    from repro_torch.launch.steps import mean_over_workers
    from repro_torch.tree import tree_map
    shapes = fs.unpack(torch.empty(fs.batch_shape + (fs.plane_size,),
                                   device="meta"))
    trees = [tree_map(lambda m: torch.randn(m.shape, generator=gen,
                                            device="cuda").to(dt), shapes)
             for dt in (getattr(torch, cfg.param_dtype), torch.float32)]

    def tensor_mean():
        tree_map(lambda x: x.copy_(x.mean(dim=0, keepdim=True).expand_as(x)),
                 trees)

    def ordered_mean():
        mean_over_workers(trees)

    turns = [cuda_ms(f) for f in (tensor_mean, ordered_mean, ordered_mean,
                                  tensor_mean)]
    del trees
    torch.cuda.empty_cache()
    planes = [torch.randn(fs.batch_shape + (fs.plane_size,), generator=gen,
                          device="cuda") for _ in range(2)]
    ranges = fs.round16_ranges()
    flat_ms = cuda_ms(lambda: (mean_planes(planes[0], ranges),
                               mean_planes(planes[1])))
    return {"per_leaf_ms": turns[1:3], "tensor_mean_ms": [turns[0], turns[3]],
            "flat_ms": flat_ms}


def flat_equals_per_leaf(small, base, fused: bool):
    """The flat and the per-leaf train steps on the card, kernels on, from
    the same weights and batches: a local, a sync and a local step (H=2).
    Params, both B² and both residuals must be bitwise equal after each."""
    import torch
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.data import SyntheticLM, make_train_batch
    from repro_torch.launch.steps import build_train_programs
    from repro_torch.tree import leaves
    shape = ShapeConfig("eq", seq_len=16, global_batch=4, kind="train")
    programs = [build_train_programs(small, OptimizerConfig(
        compression="int8", sync_fused=fused, use_kernels=True, H=2, lr=0.5,
        warmup_steps=3, flat=flat), n_workers=2, device="cuda")
        for flat in (False, True)]
    fs = programs[1].flatspace
    (pL, sL), (pF, sF) = (p.init_fn(0, base) for p in programs)
    ds = SyntheticLM(vocab_size=small.vocab_size, seq_len=shape.seq_len,
                     n_workers=2, seed=0, non_iid=True)
    for step in range(3):
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 make_train_batch(small, shape, ds, step, n_workers=2).items()}
        kind = "sync_step" if step == 1 else "local_step"
        pL, sL, _ = getattr(programs[0], kind)(pL, sL, batch)
        pF, sF, _ = getattr(programs[1], kind)(pF, sF, batch)
        pairs = [("params", pL, fs.unpack(pF))] + [
            (k, sL[k], fs.unpack(sF[k], dtype=torch.float32))
            for k in ("b2_sync", "b2_local", "res_params", "res_b2")]
        for what, a, b in pairs:
            require(all(bitwise_equal(x, y) for x, y in
                        zip(leaves(a), leaves(b))),
                    f"flat != per-leaf: {what} after step {step} "
                    f"(fused={fused})")
    return {"fused": fused, "steps": 3, "bitwise": True}


def _busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_summary(kernels, top: int = 12) -> dict:
    """Device busy ms (the union of the kernels' [start, end) intervals, in
    µs from the profiler), launches and device ms by kernel name."""
    by_name = {}
    for k0, k1, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (k1 - k0) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    shown = {}
    for k, v in ranked[:top]:          # names cut to 100 characters
        shown[k[:100]] = shown.get(k[:100], 0.0) + v
    return {"device_busy_ms": _busy_us((k0, k1) for k0, k1, _ in kernels) / 1e3,
            "device_ms_kernel_sum": sum(by_name.values()),
            "launches": len(kernels),
            "device_ms_by_kernel": shown,
            "device_ms_other_kernels": sum(v for _, v in ranked[top:])}


def profile_steps(run):
    """``run()`` (a train_loop call) under ``torch.profiler``. For each
    ``train_step`` span that train_loop records: its host wall, the device's
    busy time (the union of the kernels launched in it — train_loop
    synchronises at the end of each step) and idle share, the launches,
    and the device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.events()
    steps = sorted((e for e in events if e.name.startswith("train_step ")
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("train_step ")]
    out = []
    for s in steps:
        a, b = s.time_range.start, s.time_range.end
        summary = kernel_summary([k for k in kernels if a <= k[0] < b])
        out.append({"step": s.name, "wall_ms": (b - a) / 1e3,
                    "device_idle_share": 1.0 - summary["device_busy_ms"]
                    / ((b - a) / 1e3), **summary})
    return out


def check_mma_selftest(gen):
    """The kernels' warp-level 3xTF32 product helper alone, before any SSD
    check uses it: a (64 × 128)·(128 × 64) product in both operand layouts
    against float64, each element to MMA_TOL of Σ|a||b| (the scale of a dot
    product's rounding). A one-pass TF32 product of the same operands
    (rounded as cvt.rna does, here) must miss it, so that the check can
    see the split go wrong; a fragment layout mistake misses by far."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    a = torch.randn((64, 128), generator=gen, device="cuda")
    b = torch.randn((128, 64), generator=gen, device="cuda")
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()

    def rel(c):
        return float(((c.double() - ref).abs() / scale).max())

    out = {"tol": MMA_TOL}
    for transposed in (False, True):
        c = ssd.mma_selftest(a, b, transposed)
        torch.cuda.synchronize()
        err = rel(c)
        require(err <= MMA_TOL, f"the 3xTF32 product helper is off a "
                f"float64 product by {err} of Σ|a||b| (transposed="
                f"{transposed})")
        out["transposed" if transposed else "row_major"] = err

    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    one_pass = rel(tf32(a).double() @ tf32(b).double())
    require(one_pass > MMA_TOL, f"one TF32 pass holds the helper's "
            f"tolerance ({one_pass}): the self-test cannot see the split")
    out["one_tf32_pass"] = one_pass
    return out


def sass_tf32_mma_counts(lib) -> dict:
    """TF32 tensor-core instructions (SASS ``HMMA`` with ``TF32``) in each
    SSD kernel of the built library, by ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1]
            name = next((k for k in SSD_KERNELS if k in fn), None)
            if name and "ssd_chunk" in name:
                name += "<bf16>" if "bfloat16" in fn else "<float>"
            if name:
                counts.setdefault(name, 0)
        elif name and "HMMA" in line and "TF32" in line:
            counts[name] += 1
    return counts


def check_ssd(gen, dims, dtype, timed=True):
    """SSD chunk-scan kernel vs its plain version on the card, inputs drawn
    as the reference's kernel test draws them. Both read the same values
    (bf16 widens exactly to fp32) and sum in fp32, so bf16 inputs are held
    to the same 1e-4 as fp32 ones (the reference's 3e-2 for bf16 could not
    see the decay); the check must reject a plain run with dA 2% off."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.roofline.profile import device_ms_by_kernel
    b, nz, c, nh, hd, n = dims
    x = (torch.randn((b, nz, c, nh, hd), generator=gen, device="cuda")
         * 0.2).to(dtype)
    Bm = (torch.randn((b, nz, c, n), generator=gen, device="cuda")
          * 0.3).to(dtype)
    Cm = (torch.randn((b, nz, c, n), generator=gen, device="cuda")
          * 0.3).to(dtype)
    dA = -torch.randn((b, nz, c, nh), generator=gen, device="cuda").abs() * 0.1
    plan = ssd.launch_plan(b, nz, nh, hd, n)
    y = ssd.ssd_scan(x, Bm, Cm, dA)
    y_ref = ssd_ref(x, Bm, Cm, dA)
    torch.cuda.synchronize()
    err = max_abs_err(y, y_ref)
    require(bool(torch.isfinite(y).all()), f"SSD kernel wrote a non-finite "
            f"value ({dims}, {dtype})")
    require(torch.allclose(y, y_ref, rtol=SSD_TOL, atol=SSD_TOL),
            f"SSD kernel off its plain version ({dims}, {dtype}, max {err})")
    y_bad = ssd_ref(x, Bm, Cm, dA * 1.02)
    require(not torch.allclose(y_bad, y_ref, rtol=SSD_TOL, atol=SSD_TOL),
            f"the SSD check accepts a decay 2% off ({dims}, {dtype})")
    del y_bad, y_ref, y
    out = dict(dtype=str(dtype).replace("torch.", ""), shape=list(dims),
               max_abs_err=err, rejects_dA_2pct_off=True,
               launch_plan=plan,
               **ssd.ssd_cost(b, nz, c, nh, hd, n, x.element_size()))
    if timed:
        out.update(ms=cuda_ms(lambda: ssd.ssd_scan(x, Bm, Cm, dA)),
                   plain_ms=cuda_ms(lambda: ssd_ref(x, Bm, Cm, dA), reps=5,
                                    warmup=1))
        by_name = device_ms_by_kernel(lambda: ssd.ssd_scan(x, Bm, Cm, dA))
        out["kernel_ms"] = {k: sum(v for name, v in by_name.items()
                                   if k in name) for k in SSD_KERNELS}
        require(all(out["kernel_ms"].values()) and len(by_name) == 3,
                f"the profiler saw {sorted(by_name)} in one SSD call, want "
                f"the three kernels {SSD_KERNELS}")
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def labelled(labels):
    """While open, each function of ``labels`` (label -> [(module, name of
    the function in it)]) runs inside ``record_function(label)``."""
    from torch.profiler import record_function
    saved = []
    for label, targets in labels.items():
        for mod, name in targets:
            real = getattr(mod, name)

            def wrapped(*a, _real=real, _label=label, **kw):
                with record_function(_label):
                    return _real(*a, **kw)
            saved.append((mod, name, real))
            setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)


def model_labels() -> dict:
    """The layers of the transformer families, for ``profile_call``: the
    self- and cross-attention (forward and decode, projections included),
    the dense MLPs, the MoE layer (routing, dispatch, experts, combine) and,
    inside it, the expert GEMMs."""
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tfm
    return {"self_attention": [(attention, "self_attention"),
                               (attention, "decode_self_attention")],
            "cross_attention": [(attention, "cross_attention_full"),
                                (attention, "cross_attention_cached")],
            "mlp": [(tfm, "mlp_apply")],
            "moe": [(moe, "moe_apply")],
            "expert_gemms": [(moe, "_expert_ffn")]}


def _ms_by_label(events, labels) -> dict:
    """Device ms of the kernels that start inside each label's span on the
    device timeline (the profiler's annotation of a labelled range, from
    its first kernel to its last); ``spans``: how many it saw."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == cuda and e.name in labels]
    out = dict.fromkeys(labels, 0.0)
    for e in events:
        if e.device_type != cuda or e.name in labels or e.name == "window":
            continue
        t = e.time_range.start
        for a, b, name in spans:
            if a <= t < b:
                out[name] += e.time_range.end - t
    return {**{k: v / 1e3 for k, v in out.items()}, "spans": len(spans)}


def profile_call(fn, unprofiled_ms: float, reps: int = 1,
                 labels=None) -> dict:
    """``fn()`` under ``torch.profiler``: the device's busy time (the union of
    its kernels' intervals), its idle share against the unprofiled wall, the
    launches and the device time by kernel name. With ``reps`` > 1 the
    window holds that many calls and every figure is a mean over them (a
    short call's profile can miss events). With ``labels`` (see
    ``labelled``), also the device time of the kernels launched inside each
    label (``device_ms_by_label``; a label nested in another counts in
    both)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    labels = labels or {}
    torch.cuda.synchronize()
    with labelled(labels), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    window = next(e for e in events if e.name == "window"
                  and e.device_type == cpu)
    summary = kernel_summary(
        [(e.time_range.start, e.time_range.end, e.name) for e in events
         if e.device_type == cuda and e.name != "window"
         and e.name not in labels])
    out = {"wall_ms_profiled": (window.time_range.end
                                - window.time_range.start) / 1e3,
           "wall_ms_unprofiled": unprofiled_ms * reps, **summary}
    if labels:
        out["device_ms_by_label"] = _ms_by_label(events, labels)
    if reps > 1:
        out = {k: ({n: t / reps for n, t in v.items()} if isinstance(v, dict)
                   else v / reps) for k, v in out.items()}
        out["calls_profiled"] = reps
    out["device_idle_share_vs_unprofiled_wall"] = (
        1.0 - out["device_busy_ms"] / out["wall_ms_unprofiled"])
    return out


def reference_ssm(counter) -> dict:
    """Reduced mamba2 in float32 with ssm_pallas: the card through the SSD
    kernel against the CPU through its plain version, same weights."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(reduced(get_arch("mamba2-370m")),
                              param_dtype="float32", ssm_pallas=True)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(3))
    card = tree_map(lambda t: t.cuda(), cpu)
    B, L, n_dec = 4, 71, 8                 # 71: padded to the 16-token chunk
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=L + n_dec,
                        seed=1).worker_batch(0, 0, B)
    tokens = torch.from_numpy(batch["tokens"])

    def close(a, b, what):
        return require_close(a, b, f"reduced mamba2: {what}")

    out = {"arch": cfg.name, "batch": B, "seq": L, "rtol": MODEL_RTOL,
           "atol": MODEL_ATOL}
    with torch.inference_mode():
        counter.reset()
        lg_card = model.logits_fn(card, {"tokens": tokens[:, :L].cuda()})
        torch.cuda.synchronize()
        require(counter.n == cfg.n_layers, f"reduced forward launched the SSD "
                f"kernel {counter.n} times, want {cfg.n_layers}")
        out["ssd_launches_per_forward"] = counter.n
        lg_cpu = model.logits_fn(cpu, {"tokens": tokens[:, :L]})
        out["logits_max_abs_err"] = close(lg_card, lg_cpu, "logits_fn")

        # prefill, then decode n_dec tokens teacher-forced, card vs CPU
        errs = []
        runs = []
        for params, dev in ((card, "cuda"), (cpu, "cpu")):
            pl, cache = model.prefill(params, {"tokens": tokens[:, :L].to(dev)})
            steps = [pl]
            for t in range(n_dec):
                lg, cache = model.decode_step(
                    params, cache, tokens[:, L + t:L + t + 1].to(dev),
                    torch.full((B,), L + t, dtype=torch.int32, device=dev))
                steps.append(lg)
            runs.append((steps, leaves(cache)))
        for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0])):
            errs.append(close(a, b, f"prefill/decode step {i} logits"))
        for a, b in zip(runs[0][1], runs[1][1]):
            errs.append(close(a, b, "decode cache"))
        out["prefill_decode_max_abs_err"] = max(errs)

        # on the card: the recurrence from a zero cache vs the kernel forward
        cache = model.init_cache(B, L, device="cuda")
        dec = []
        for t in range(L):
            lg, cache = model.decode_step(
                card, cache, tokens[:, t:t + 1].cuda(),
                torch.full((B,), t, dtype=torch.int32, device="cuda"))
            dec.append(lg[:, 0])
        out["decode_vs_kernel_forward_max_abs_err"] = close(
            torch.stack(dec, dim=1), lg_card, "decode by the recurrence vs "
            "the kernel forward")
    return out


def score_model(cfg, params, counters, *, batch, seq, ssd_calls, reps=3,
                extra=None, labels=None):
    """logits_fn and loss_fn of ``cfg`` over batch x seq tokens of the
    synthetic stream (with the tensors of ``extra``, image embeddings or
    audio frames, in each batch), ``reps`` times each, under inference
    mode, with every launch count set to 0 just before and read just after
    (``ssd_calls`` SSD wrapper calls a forward required); then one warm
    forward under torch.profiler (by ``labels`` too, where given). Returns
    (report, launches)."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    model = build_model(cfg)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       seed=0).worker_batch(0, 0, batch)
    sb = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    extra = extra or {}
    sb.update(extra)
    fwd_batch = {"tokens": sb["tokens"], **extra}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms, loss_ms, losses, aux = [], [], [], []
    with torch.inference_mode():
        for c in counters.values():
            c.reset()
        for _ in range(reps):
            n0 = ssd.launches.n
            t0 = time.perf_counter()
            logits = model.logits_fn(params, fwd_batch)
            torch.cuda.synchronize()
            fwd_ms.append(1e3 * (time.perf_counter() - t0))
            require(ssd.launches.n - n0 == ssd_calls,
                    f"a forward launched the SSD kernel "
                    f"{ssd.launches.n - n0} times, want {ssd_calls}")
            require(tuple(logits.shape) == (batch, seq, cfg.vocab_size)
                    and bool(torch.isfinite(logits).all()),
                    f"logits {tuple(logits.shape)} not finite")
            del logits
            t0 = time.perf_counter()
            _, metrics = model.loss_fn(params, sb)
            losses.append(float(metrics["xent"]))      # synchronises
            aux.append(float(metrics["aux"]))
            loss_ms.append(1e3 * (time.perf_counter() - t0))
        launches = read_counts(counters)
    require(all(abs(x - math.log(cfg.vocab_size)) <= 1.5 for x in losses),
            f"initial xent {losses} vs ln V {math.log(cfg.vocab_size)}")
    fwd_med = statistics.median(fwd_ms)
    out = {"arch": cfg.name, "params": count_params(cfg), "batch": batch,
           "seq": seq, "dtype": cfg.param_dtype, "launches": launches,
           "forward_ms": fwd_ms, "forward_ms_median": fwd_med,
           "loss_fn_ms": loss_ms, "xent": losses, "aux": aux,
           "tokens_per_s": batch * seq / (fwd_med / 1e3),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    require(out["max_memory_allocated_gb"] < 80.0,
            f"scoring peak {out['max_memory_allocated_gb']} GB")
    with torch.inference_mode():
        out["profile"] = profile_call(
            lambda: model.logits_fn(params, fwd_batch), fwd_med,
            labels=labels)
    return out, launches


def serve_run(cfg, params, counters, *, batch, prompt, new,
              replay=SERVE_REPLAY):
    """serve_session on the card, its prompt cut to ``replay`` positions
    (the session replays its prompt through decode_step, one step a
    position: at 512 those replays took most of the script's wall), with
    every launch count set to 0 just before and read after both parts;
    then the serving numbers at ``prompt`` (time_serving). Returns
    (report, launches, stats): the session's stats, at ``replay``."""
    import torch
    from repro_torch.launch.serve import serve_session
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    stats = {}
    gen, tps = serve_session(cfg, batch=batch, prompt_len=replay,
                             new_tokens=new, seed=0, device="cuda",
                             params=params, verbose=False, stats=stats)
    require(gen.shape == (batch, new)
            and bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
            f"generated tokens {gen.shape} outside the vocabulary")
    require(stats["logits_finite"], "serving produced a non-finite logit")
    timed = time_serving(cfg, params, batch=batch, prompt=prompt, new=new)
    launches = {name: c.n for name, c in counters.items()}
    out = {"arch": cfg.name, "batch": batch, "prompt_len": prompt,
           "new_tokens": new, "launches": launches, **timed,
           "session": {
               "prompt_len": replay, "new_tokens": new,
               "prefill_ms": 1e3 * stats["prefill_s"],
               "decode_steps": stats["decode_steps"],
               "decode_ms_per_step":
                   1e3 * stats["decode_s"] / stats["decode_steps"],
               "tokens_per_s": tps},
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sample": gen[0, :8].tolist()}
    return out, launches, stats


def time_serving(cfg, params, *, batch, prompt, new, steps=8) -> dict:
    """The serving numbers at a prompt of ``prompt``, through the programs
    serve_session runs: the prefill of batch x prompt tokens (the second of
    two calls), and ``steps`` decode steps at positions prompt, prompt + 1,
    ... over a zero cache of the session's geometry (prompt + new slots),
    each synchronised (median). decode_tokens_per_s: batch tokens a
    decode step."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.serving import (build_serve_programs,
                                            decode_cache_specs,
                                            serve_batch_specs)
    from repro_torch.tree import tree_map
    shape = ShapeConfig(name="decode_32k", seq_len=prompt + new,
                        global_batch=batch, kind="decode")
    programs = build_serve_programs(cfg, shape)
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=prompt, seed=0).worker_batch(
            0, 0, batch)["tokens"]).cuda()
    pre = {"tokens": prompts}
    for k, v in serve_batch_specs(cfg, ShapeConfig(
            name="prefill", seq_len=prompt, global_batch=batch,
            kind="prefill"))["prefill"].items():
        if k != "tokens":
            pre[k] = torch.zeros(v.shape, dtype=v.dtype, device="cuda")
    walls = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = programs.prefill(params, pre)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        require(bool(torch.isfinite(logits).all()),
                f"{cfg.name}: non-finite prefill logit at prompt {prompt}")
        del logits
        cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype,
                                                device="cuda"),
                         decode_cache_specs(cfg, shape))
        tok = prompts[:, -1:]
        decode = []
        for i in range(steps):
            pos = torch.full((batch,), prompt + i, dtype=torch.int32,
                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = programs.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            torch.cuda.synchronize()
            decode.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(decode)
    return {"prefill_ms": 1e3 * walls[1], "decode_ms_per_step": ms,
            "decode_steps_timed": steps, "decode_tokens_per_s": batch * 1e3 / ms}


def serve_mamba2(cfg, params, counters, *, batch, prompt, new, k=64):
    """serve_run on mamba2: prefill takes the chunked SSD (it needs the
    last state) and decode the recurrence, as in the JAX package, so the SSD
    kernel is not launched. Also reported, not required: the decode logits
    over the first ``k`` prompt positions against the kernel forward's.
    Returns (report, launches)."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    out, launches, _ = serve_run(cfg, params, counters, batch=batch,
                                 prompt=prompt, new=new)
    model = build_model(cfg)
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=prompt, seed=0).worker_batch(
            0, 0, batch)["tokens"][:, :k]).cuda()
    with torch.inference_mode():
        fwd = model.logits_fn(params, {"tokens": prompts}).float()
        cache = model.init_cache(batch, k, device="cuda")
        diffs = []
        for t in range(k):
            lg, cache = model.decode_step(
                params, cache, prompts[:, t:t + 1],
                torch.full((batch,), t, dtype=torch.int32, device="cuda"))
            diffs.append((lg[:, 0].float() - fwd[:, t]).abs())
        diffs = torch.stack(diffs)
        # where a decode step's time goes: one more step, profiled
        out["decode_step_profile"] = profile_call(
            lambda: model.decode_step(
                params, cache, prompts[:, :1],
                torch.full((batch,), k, dtype=torch.int32, device="cuda")),
            out["decode_ms_per_step"])
    out[f"decode_vs_kernel_forward_first_{k}"] = {
        "max_abs_diff": float(diffs.max()), "mean_abs_diff": float(diffs.mean()),
        "logit_max_abs": float(fwd.abs().max()),
        "logit_mean_abs": float(fwd.abs().mean())}
    return out, launches


def rel_l2(a, b) -> float:
    """‖a − b‖₂ / ‖b‖₂ in float32."""
    import torch
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def serve_model(cfg, params, counters, faults, *, batch, prompt, new,
                reported=None, labels=None, replay=SERVE_REPLAY):
    """serve_run on a dense or LSTM model (no kernel of the port's reaches
    either), then: the prefill's logits for the prompt's last position
    against its replay through decode_step, to SERVE_REL_L2 (relative L2
    over the batch's logits), with each of ``faults`` (name -> a function
    of the prompts giving faulty prefill logits) required to exceed it and
    each of ``reported`` measured; one decode step from a zero cache of the
    session's length under torch.profiler (the mean of 5). Returns
    (report, launches)."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    out, launches, stats = serve_run(cfg, params, counters, batch=batch,
                                     prompt=prompt, new=new, replay=replay)
    model = build_model(cfg)
    # the session's prompts: its prefill and its replay are compared
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=replay, seed=0).worker_batch(
            0, 0, batch)["tokens"]).cuda()
    want = stats["replay_logits"]
    err = rel_l2(stats["prefill_logits"], want)
    out["prefill_vs_replay"] = {
        "position": replay - 1, "rel_l2": err, "tol": SERVE_REL_L2,
        "max_abs_diff": max_abs_err(stats["prefill_logits"], want),
        "logit_max_abs": float(want.float().abs().max())}
    require(err <= SERVE_REL_L2, f"{cfg.name}: prefill's last logits off "
            f"the replay's by {err} (relative L2)")
    with torch.inference_mode():
        for name, fault in {**faults, **(reported or {})}.items():
            bad = rel_l2(fault(prompts), want)
            out["prefill_vs_replay"][f"fault_{name}_rel_l2"] = bad
            require(bad > SERVE_REL_L2 or name not in faults,
                    f"{cfg.name}: the prefill/replay check accepts a fault "
                    f"({name}: {bad})")
        out["decode_step_profile"] = profile_decode_step(
            model, params, out, batch, prompt, new, labels)
    return out, launches


def profile_decode_step(model, params, out, batch, prompt, new, labels=None):
    """One decode step at position ``prompt`` from a zero cache of the
    session's geometry (``decode_cache_specs``, and its window), under
    torch.profiler: the mean of 5."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.serving import cache_geometry, decode_cache_specs
    from repro_torch.tree import tree_map
    shape = ShapeConfig(name="decode_32k", seq_len=prompt + new,
                        global_batch=batch, kind="decode")
    window = cache_geometry(model.cfg, shape)[1]
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device="cuda"),
                     decode_cache_specs(model.cfg, shape))
    tok = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((batch,), prompt, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        return profile_call(lambda: model.decode_step(params, cache, tok, pos,
                                                      window=window),
                            out["decode_ms_per_step"], reps=5, labels=labels)


def require_close(a, b, what: str) -> float:
    """a and b within MODEL_RTOL / MODEL_ATOL, on the CPU in float32;
    returns the max abs error."""
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    err = max_abs_err(a, b)
    require(torch.allclose(a, b, rtol=MODEL_RTOL, atol=MODEL_ATOL),
            f"{what} differs (max abs {err})")
    return err


def decode_replay(model, params, tokens, cache_len, window=0):
    """decode_step over every position of ``tokens`` (B, S) from a zero
    cache of ``cache_len`` slots; the logits stacked (B, S, V)."""
    import torch
    B, S = tokens.shape
    dev = tokens.device
    cache = model.init_cache(B, cache_len, windowed=bool(window), device=dev)
    out = []
    for t in range(S):
        lg, cache = model.decode_step(
            params, cache, tokens[:, t:t + 1],
            torch.full((B,), t, dtype=torch.int32, device=dev), window=window)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


@contextlib.contextmanager
def queries_rotated_ahead(n_heads: int):
    """A fault: RoPE rotates the queries (the tensors with ``n_heads``
    heads) one position ahead of the keys, while the context is open."""
    from repro_torch.models import attention
    real = attention.apply_rope
    attention.apply_rope = lambda x, positions, theta: real(
        x, positions + int(x.shape[-2] == n_heads), theta)
    try:
        yield
    finally:
        attention.apply_rope = real


def rotated_prefill(model, params, tokens):
    """The prefill's last logits with queries rotated a position ahead."""
    with queries_rotated_ahead(model.cfg.n_heads):
        return model.prefill(params, prefill_batch(model.cfg, tokens))[0]


def scaled_queries(params, factor: float):
    """A fault: the parameters with wq and bq scaled by ``factor``, which
    scales every attention score by it."""
    def one(blk):
        attn = dict(blk["attn"])
        attn["wq"] = attn["wq"] * factor
        if "bq" in attn:
            attn["bq"] = attn["bq"] * factor
        return {**blk, "attn": attn}
    return {**params, "blocks": [one(b) for b in params["blocks"]]}


def reference_dense(counters) -> dict:
    """Reduced qwen2-7b in float32 (random QKV biases), card against CPU,
    same weights: logits_fn over 2 x 2560 tokens (the blockwise path, its
    last block padded), prefill then decode steps, and a windowed decode
    past the window; on the card, the prompt replayed through decode_step
    against logits_fn position by position, which must reject queries
    rotated a position ahead and scores scaled 2% up. No kernel of the
    port's is launched."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(reduced(get_arch("qwen2-7b")),
                              param_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(5)
    cpu = model.init(gen)
    for blk in cpu["blocks"]:            # the reference initialises them to 0
        for name in ("bq", "bk", "bv"):
            blk["attn"][name] = 0.5 * torch.randn(
                blk["attn"][name].shape, generator=gen)
    card = tree_map(lambda t: t.cuda(), cpu)
    B, L, n_dec, W, n_fault = 2, 2560, 16, cfg.sliding_window, 256
    tokens = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=L + n_dec, seed=1).worker_batch(
            0, 0, B)["tokens"])
    out = {"arch": cfg.name, "batch": B, "seq": L, "kv_block": 1024,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "rtol": MODEL_RTOL, "atol": MODEL_ATOL}
    for c in counters.values():
        c.reset()
    with torch.inference_mode():
        lg_card = model.logits_fn(card, {"tokens": tokens[:, :L].cuda()})
        lg_cpu = model.logits_fn(cpu, {"tokens": tokens[:, :L]})
        out["logits_max_abs_err"] = require_close(
            lg_card, lg_cpu, "reduced qwen2: logits_fn (blockwise)")
        del lg_cpu

        # prefill into a cache with room for n_dec more, then decode them
        runs = []
        for params, dev in ((card, "cuda"), (cpu, "cpu")):
            pl, pre = model.prefill(params, {"tokens": tokens[:, :L].to(dev)})
            room = model.init_cache(B, L + n_dec, device=dev)
            cache = [{"kv": tuple(torch.cat([p, z[:, :, L:]], dim=2)
                                  for p, z in zip(e["kv"], r["kv"]))}
                     for e, r in zip(pre, room)]
            steps = [pl]
            for t in range(n_dec):
                lg, cache = model.decode_step(
                    params, cache, tokens[:, L + t:L + t + 1].to(dev),
                    torch.full((B,), L + t, dtype=torch.int32, device=dev))
                steps.append(lg)
            runs.append((steps, leaves(cache)))
        errs = [require_close(a, b, f"reduced qwen2: prefill/decode step {i}")
                for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0]))]
        errs += [require_close(a, b, "reduced qwen2: decode cache")
                 for a, b in zip(runs[0][1], runs[1][1])]
        out["prefill_decode_max_abs_err"] = max(errs)
        del runs

        # on the card: the replay against the forward, then two faults
        rep = decode_replay(model, card, tokens[:, :L].cuda(), L)
        out["replay_vs_logits_fn_max_abs_err"] = require_close(
            rep, lg_card, "reduced qwen2: decode replay vs logits_fn")
        ref = lg_card[:, :n_fault]
        short = tokens[:, :n_fault].cuda()
        with queries_rotated_ahead(cfg.n_heads):
            rot = decode_replay(model, card, short, n_fault)
        bad = {"queries_rotated_one_ahead": rot,
               "scores_scaled_2pct": decode_replay(
                   model, scaled_queries(card, 1.02), short, n_fault)}
        out["faults_first_positions"] = n_fault
        for name, lg in bad.items():
            require(not torch.allclose(lg.cpu(), ref.cpu(), rtol=MODEL_RTOL,
                                       atol=MODEL_ATOL),
                    f"the replay check accepts a fault ({name})")
            out[f"fault_{name}_max_abs_err"] = max_abs_err(lg, ref)

        # a ring of W slots over W + 32 positions, card vs CPU
        n_win = W + 32
        win_card = decode_replay(model, card, tokens[:, :n_win].cuda(), W,
                                 window=W)
        win_cpu = decode_replay(model, cpu, tokens[:, :n_win], W, window=W)
        out["windowed"] = {
            "window": W, "positions": n_win,
            "max_abs_err": require_close(win_card, win_cpu,
                                         "reduced qwen2: windowed decode"),
            # past the window the ring forgets: off the full forward there
            "vs_full_forward_past_window_max_abs": max_abs_err(
                win_card[:, W:], lg_card[:, W:n_win])}
        require_close(win_card[:, :W], lg_card[:, :W],
                      "reduced qwen2: windowed decode within the window")
    out["launches"] = require_launches(read_counts(counters))
    return out


def reference_lstm_serve(counters) -> dict:
    """Reduced Big LSTM in float32: on each device the prefill's last
    logits against lstm_logits' last position; prefill and decode steps
    card against CPU, same weights. No kernel of the port's is launched."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(reduced(get_arch("biglstm")),
                              param_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(3))
    card = tree_map(lambda t: t.cuda(), cpu)
    B, L, n_dec = 4, 71, 8
    tokens = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=L + n_dec, seed=1).worker_batch(
            0, 0, B)["tokens"])
    out = {"arch": cfg.name, "batch": B, "seq": L, "rtol": MODEL_RTOL,
           "atol": MODEL_ATOL}
    for c in counters.values():
        c.reset()
    runs = []
    with torch.inference_mode():
        for params, dev in ((card, "cuda"), (cpu, "cpu")):
            fwd = model.logits_fn(params, {"tokens": tokens[:, :L].to(dev)})
            pl, state = model.prefill(params,
                                      {"tokens": tokens[:, :L].to(dev)})
            out[f"prefill_vs_forward_{dev}_max_abs_err"] = require_close(
                pl[:, 0], fwd[:, -1], f"reduced Big LSTM on {dev}: prefill "
                "vs lstm_logits' last position")
            steps = [pl]
            for t in range(n_dec):
                lg, state = model.decode_step(
                    params, state, tokens[:, L + t:L + t + 1].to(dev),
                    torch.full((B,), L + t, dtype=torch.int32, device=dev))
                steps.append(lg)
            runs.append((steps, leaves(state)))
    errs = [require_close(a, b, f"reduced Big LSTM: prefill/decode step {i}")
            for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0]))]
    errs += [require_close(a, b, "reduced Big LSTM: decode state")
             for a, b in zip(runs[0][1], runs[1][1])]
    out["prefill_decode_max_abs_err"] = max(errs)
    out["launches"] = require_launches(read_counts(counters))
    return out


@contextlib.contextmanager
def moe_fault(name: str):
    """A fault in the MoE layer while the context is open:
    ``gates_not_renormalised`` (top-k gates left as the router's
    probabilities) or ``capacity_ignored`` (every expert takes every
    choice routed to it)."""
    import torch
    from repro_torch.models import moe
    real_router, real_capacity = moe._router, moe._capacity

    def raw_gates(params, xt, cfg, group=None):
        gate_vals, gate_idx, probs, slot, keep, size = real_router(
            params, xt, cfg, group)
        raw = torch.gather(probs, 1, gate_idx) * keep
        return raw, gate_idx, probs, slot, keep, size

    if name == "gates_not_renormalised":
        moe._router = raw_gates
    elif name == "capacity_ignored":
        moe._capacity = lambda n_tokens, n_experts, top_k, factor: (
            n_tokens * top_k)
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        moe._router, moe._capacity = real_router, real_capacity


@contextlib.contextmanager
def recorded_routing(log: list):
    """While open, each MoE layer appends its (T, k) expert ids and kept
    mask to ``log`` (copies: not for timed runs)."""
    from repro_torch.models import moe
    real = moe._router

    def rec(params, xt, cfg, group=None):
        out = real(params, xt, cfg, group)
        log.append((out[1].clone(), out[4].clone()))
        return out
    moe._router = rec
    try:
        yield
    finally:
        moe._router = real


def dropped_share(log) -> float:
    kept = sum(int(keep.sum()) for _, keep in log)
    return 1.0 - kept / max(sum(keep.numel() for _, keep in log), 1)


def routing_flips(prefill_log, replay_log, batch: int, n_layers: int):
    """The share of tokens, per MoE layer, whose set of experts differs
    between a prefill over (batch, S) tokens and its replay through S
    decode steps."""
    import torch
    out = []
    for layer in range(n_layers):
        a = prefill_log[layer][0].reshape(batch, -1, prefill_log[layer][0]
                                          .shape[-1])
        b = torch.stack([ids for ids, _ in replay_log[layer::n_layers]], 1)
        out.append(float((a.sort(-1).values != b.sort(-1).values)
                         .any(-1).float().mean()))
    return out


def set_gates(params, value: float):
    """The params with every cross-attention layer's tanh gate at
    ``value`` (the reference initialises it to 0, where the image layers
    add nothing)."""
    import torch
    return {**params, "blocks": [
        {**b, "gate": torch.full_like(b["gate"], value)} if "gate" in b
        else b for b in params["blocks"]]}


def prefill_batch(cfg, tokens):
    """A serving prefill batch as serve_session builds it: the tokens and
    zero image embeddings / audio frames."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.serving import serve_batch_specs
    shape = ShapeConfig(name="prefill", seq_len=tokens.shape[1],
                        global_batch=tokens.shape[0], kind="prefill")
    return {k: tokens if k == "tokens" else torch.zeros(
        v.shape, dtype=v.dtype, device=tokens.device)
        for k, v in serve_batch_specs(cfg, shape)["prefill"].items()}


@contextlib.contextmanager
def causal_encoder():
    """A fault: the encoder-decoder's encoder runs causally while the
    context is open."""
    from repro_torch.models import transformer as tfm
    real = tfm.apply_stack

    def causal(params, cfg, x, positions, ctx=None, **kw):
        if ctx and ctx.get("causal") is False:
            ctx = {**ctx, "causal": True}
        return real(params, cfg, x, positions, ctx, **kw)
    tfm.apply_stack = causal
    try:
        yield
    finally:
        tfm.apply_stack = real


def card_vs_cpu(model, card, cpu, batch, L, n_dec, what, cross_len=0):
    """One reduced float32 model on the card and on the CPU, same weights
    and batch (tokens of L + n_dec positions; labels; image embeddings or
    audio frames): logits_fn, loss_fn (loss with the MoE aux, and the aux),
    prefill over L tokens (logits and caches), then n_dec decode steps from
    the prefill's caches. Returns (report, card logits_fn logits, CPU
    logits)."""
    import torch
    from repro_torch.tree import leaves
    B = batch["tokens"].shape[0]
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    out = {}
    runs = []
    for params, dev in ((card, "cuda"), (cpu, "cpu")):
        b = {k: v.to(dev) for k, v in batch.items()}
        fwd = {"tokens": b["tokens"][:, :L], **{k: b[k] for k in extra}}
        logits = model.logits_fn(params, fwd)
        loss, met = model.loss_fn(params, {**fwd,
                                           "labels": b["labels"][:, :L]})
        pl, pre = model.prefill(params, fwd)
        # the prefill's caches with room for n_dec more self-attention slots
        room = model.init_cache(B, L + n_dec, cross_len=cross_len, device=dev)
        cache = [{k: (tuple(torch.cat([p, z[:, :, L:]], dim=2)
                            for p, z in zip(e[k], r[k])) if k == "kv"
                      else e[k]) for k in r} for e, r in zip(pre, room)]
        steps = [pl]
        for t in range(n_dec):
            lg, cache = model.decode_step(
                params, cache, b["tokens"][:, L + t:L + t + 1],
                torch.full((B,), L + t, dtype=torch.int32, device=dev))
            steps.append(lg)
        runs.append((logits, float(loss), float(met["aux"]), leaves(pre),
                     steps, leaves(cache)))
    (lg_a, loss_a, aux_a, pre_a, st_a, c_a), (lg_b, loss_b, aux_b, pre_b,
                                               st_b, c_b) = runs
    out["logits_max_abs_err"] = require_close(lg_a, lg_b,
                                              f"{what}: logits_fn")
    for name, a, b in (("loss", loss_a, loss_b), ("aux", aux_a, aux_b)):
        require(abs(a - b) <= MODEL_RTOL * abs(b) + MODEL_ATOL,
                f"{what}: {name} {a} on the card, {b} on the CPU")
        out[name] = {"cuda": a, "cpu": b}
    out["prefill_cache_max_abs_err"] = max(
        require_close(a, b, f"{what}: prefill cache")
        for a, b in zip(pre_a, pre_b))
    out["prefill_decode_max_abs_err"] = max(
        [require_close(a, b, f"{what}: prefill/decode step {i}")
         for i, (a, b) in enumerate(zip(st_a, st_b))]
        + [require_close(a, b, f"{what}: decode cache")
           for a, b in zip(c_a, c_b)])
    return out, lg_a, lg_b


def fault_rejected(got, want, what: str) -> float:
    """A faulty run's logits must fall outside the tolerance."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    require(not torch.allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL),
            f"the card-vs-CPU check accepts a fault ({what})")
    return max_abs_err(got, want)


def reference_moe(counters) -> dict:
    """Reduced phi3.5-moe (4 experts, top-2) with its router, and with a
    zero router (every probability ties: the lowest ids win, experts 0 and
    1 take every token, capacity drops most choices), and reduced
    llama4-maverick (top-1, shared expert, MoE every other layer), in
    float32, card against CPU with the same weights: logits_fn, loss_fn
    with the aux loss, prefill caches, decode steps after the prefill and
    the prompt replayed through decode_step from a zero cache. Top-2 gates
    left un-renormalised and capacity ignored must fail the check (the
    latter where the forward drops a choice). No kernel of the port's is
    launched."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    from repro_torch.models.moe import _capacity
    B, L, n_dec = 4, 96, 8
    out = {"rtol": MODEL_RTOL, "atol": MODEL_ATOL, "batch": B, "seq": L,
           "cases": []}
    for c in counters.values():
        c.reset()
    for arch, zero_router in (("phi3.5-moe-42b-a6.6b", False),
                              ("phi3.5-moe-42b-a6.6b", True),
                              ("llama4-maverick-400b-a17b", False)):
        cfg = dataclasses.replace(reduced(get_arch(arch)),
                                  param_dtype="float32")
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(7))
        if zero_router:
            for blk in cpu["blocks"]:
                if "moe" in blk:
                    blk["moe"]["router"].zero_()
        card = tree_map(lambda t: t.cuda(), cpu)
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=L + n_dec,
                           seed=1).worker_batch(0, 0, B)
        batch = {k: torch.from_numpy(v) for k, v in data.items()}
        what = f"reduced {arch}" + (" (zero router)" if zero_router else "")
        case = {"arch": cfg.name, "zero_router": zero_router,
                "experts": cfg.n_experts, "top_k": cfg.top_k,
                "capacity": None}
        with torch.inference_mode():
            rep, lg_card, lg_cpu = card_vs_cpu(model, card, cpu, batch, L,
                                               n_dec, what)
            case.update(rep)
            tokens = batch["tokens"][:, :L]
            log = []
            with recorded_routing(log):
                model.logits_fn(card, {"tokens": tokens.cuda()})
            case["forward_dropped_share"] = dropped_share(log)
            case["capacity"] = _capacity(B * L, cfg.n_experts, cfg.top_k,
                                         cfg.capacity_factor)
            if zero_router:
                require(case["forward_dropped_share"] > 0.3,
                        f"{what}: capacity dropped only "
                        f"{case['forward_dropped_share']} of the choices")
            # the prompt replayed from a zero cache, card vs CPU
            rep_card = decode_replay(model, card, tokens.cuda(), L)
            rep_cpu = decode_replay(model, cpu, tokens, L)
            case["replay_max_abs_err"] = require_close(
                rep_card, rep_cpu, f"{what}: decode replay")
            case["replay_vs_forward_max_abs_diff"] = max_abs_err(rep_card,
                                                                 lg_card)
            faults = {}
            if cfg.top_k > 1:
                faults["gates_not_renormalised"] = True
            faults["capacity_ignored"] = case["forward_dropped_share"] > 0
            for name, required in faults.items():
                with moe_fault(name):
                    bad = model.logits_fn(card, {"tokens": tokens.cuda()})
                if required:
                    case[f"fault_{name}_max_abs_err"] = fault_rejected(
                        bad, lg_cpu, f"{what}: {name}")
                else:
                    case[f"fault_{name}_max_abs_err_reported"] = max_abs_err(
                        bad.cpu(), lg_cpu)
        out["cases"].append(case)
    out["launches"] = require_launches(read_counts(counters))
    return out


def reference_cross(counters) -> dict:
    """Reduced llama-3.2-vision (16 image tokens, tanh gate set to 0.7) and
    seamless-m4t (2 + 2 layers) in float32 with the reference's modality
    stubs (normal x 0.02), card against CPU with the same weights, as
    reference_moe compares them; seamless over 96 frames and over 2,500,
    where the encoder and the decoder's cross-attention take the blockwise
    path with 572 padded keys. On the card, the prompt replayed through
    decode_step with the prefill's cross (k, v) copied into the cache
    against logits_fn: equal where the cross keys take the direct path;
    over 2,500 frames the replay's direct attention leaves out the padded
    keys that the forward's includes (a reference caveat), and the
    difference is reported. The gate ignored and the encoder run causally
    must fail the card-vs-CPU check."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.data import SyntheticLM, make_train_batch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    B, L, n_dec = 2, 96, 8
    out = {"rtol": MODEL_RTOL, "atol": MODEL_ATOL, "batch": B, "seq": L,
           "gate": CROSS_GATE, "cases": []}
    for c in counters.values():
        c.reset()
    for arch, frames in (("llama-3.2-vision-11b", 0),
                         ("seamless-m4t-large-v2", L),
                         ("seamless-m4t-large-v2", 2500)):
        cfg = dataclasses.replace(reduced(get_arch(arch)),
                                  param_dtype="float32")
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(5))
        if cfg.cross_attn_every:
            cpu = set_gates(cpu, CROSS_GATE)
        card = tree_map(lambda t: t.cuda(), cpu)
        shape = ShapeConfig("reference", seq_len=L + n_dec, global_batch=B,
                            kind="train")
        data = make_train_batch(cfg, shape, SyntheticLM(
            vocab_size=cfg.vocab_size, seq_len=L + n_dec, seed=1), 0)
        if cfg.is_encdec:
            data["audio_frames"] = (np.random.default_rng(2).standard_normal(
                (B, frames, cfg.d_model)) * 0.02).astype(np.float32)
        batch = {k: torch.from_numpy(v) for k, v in data.items()}
        cross_len = frames or cfg.n_image_tokens
        what = f"reduced {arch}, {cross_len} cross keys"
        case = {"arch": cfg.name, "cross_len": cross_len}
        with torch.inference_mode():
            rep, lg_card, lg_cpu = card_vs_cpu(model, card, cpu, batch, L,
                                               n_dec, what,
                                               cross_len=cross_len)
            case.update(rep)
            fwd = {k: v[:, :L] if k == "tokens" else v
                   for k, v in batch.items() if k != "labels"}
            fwd_card = {k: v.cuda() for k, v in fwd.items()}
            # on the card: the replay with the prefill's cross (k, v)
            _, pre = model.prefill(card, fwd_card)
            cache = [{**c, "xkv": p["xkv"]} if "xkv" in c else c
                     for c, p in zip(model.init_cache(
                         B, L, cross_len=cross_len, device="cuda"), pre)]
            steps = []
            for t in range(L):
                lg, cache = model.decode_step(
                    card, cache, fwd_card["tokens"][:, t:t + 1],
                    torch.full((B,), t, dtype=torch.int32, device="cuda"))
                steps.append(lg[:, 0])
            replay = torch.stack(steps, dim=1)
            if cross_len <= 2048:
                case["replay_vs_logits_fn_max_abs_err"] = require_close(
                    replay, lg_card, f"{what}: replay vs logits_fn")
            else:
                case["replay_vs_logits_fn_padded_keys_max_abs_diff"] = (
                    max_abs_err(replay, lg_card))
            if cfg.cross_attn_every:
                # tanh(+inf) = 1: the output of x + out, the gate ignored
                bad = model.logits_fn(set_gates(card, float("inf")),
                                      fwd_card)
                case["fault_gate_ignored_max_abs_err"] = fault_rejected(
                    bad, lg_cpu, f"{what}: gate ignored")
            elif cross_len <= 2048:
                with causal_encoder():
                    bad = model.logits_fn(card, fwd_card)
                case["fault_encoder_causal_max_abs_err"] = fault_rejected(
                    bad, lg_cpu, f"{what}: encoder run causally")
        out["cases"].append(case)
    out["launches"] = require_launches(read_counts(counters))
    return out


def moe_score_phase(cfg, params, counters) -> dict:
    """score_model at 2 x 4096 tokens with the MoE labels, and the share of
    (token, choice) pairs that capacity dropped in one more forward."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.moe import _capacity
    out, launches = score_model(cfg, params, counters, batch=2, seq=4096,
                                ssd_calls=0, labels=model_labels())
    tokens = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=4096, seed=0).worker_batch(
            0, 0, 2)["tokens"]).cuda()
    log = []
    with torch.inference_mode(), recorded_routing(log):
        build_model(cfg).logits_fn(params, {"tokens": tokens})
    out["capacity"] = _capacity(2 * 4096, cfg.n_experts, cfg.top_k,
                                cfg.capacity_factor)
    out["dropped_share"] = dropped_share(log)
    out["dropped_share_by_layer"] = [dropped_share([e]) for e in log]
    return out, launches


def serve_moe(cfg, params, counters, *, batch, prompt, new) -> dict:
    """serve_run on an MoE model, then the capacity drops of its prefill
    (batch x prompt tokens) and of decode steps (batch tokens each, replayed
    over the first 64 prompt positions). Capacity depends on the number of
    tokens routed together, so the reference's prefill and its replay
    through decode_step are different functions wherever the prefill drops
    choices: their relative L2 is reported. With capacity unbounded
    (capacity_factor E / top_k: capacity T), over the first 128 positions:
    in bf16 the two paths' rounding flips some top-2 choices, reported by
    layer with the relative L2; the check runs in float32, at full width
    over MOE_LAYERS layers with weights of its own, to
    SERVE_REL_L2, which a prefill one token short and one with
    un-renormalised gates must exceed. One profiled decode step, by label.
    Returns (report, launches)."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    check_len, check_layers = 128, MOE_LAYERS
    out, launches, stats = serve_run(cfg, params, counters, batch=batch,
                                     prompt=prompt, new=new)
    model = build_model(cfg)
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=prompt, seed=0).worker_batch(
            0, 0, batch)["tokens"]).cuda()
    out["prefill_vs_replay_capacity_bound"] = {
        "position": SERVE_REPLAY - 1,
        "rel_l2": rel_l2(stats["prefill_logits"], stats["replay_logits"])}
    unbounded = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    short = {"tokens": prompts[:, :check_len]}
    with torch.inference_mode():
        log = []
        with recorded_routing(log):
            model.prefill(params, {"tokens": prompts})
        out["prefill_dropped_share"] = dropped_share(log)
        log = []
        with recorded_routing(log):
            decode_replay(model, params, prompts[:, :64], 64)
        out["decode_dropped_share_first_64"] = dropped_share(log)

        free = build_model(unbounded)
        pre, rep = [], []
        with recorded_routing(pre):
            got = free.prefill(params, short)[0][:, 0]
        with recorded_routing(rep):
            want = decode_replay(free, params, short["tokens"],
                                 check_len)[:, -1]
        out["prefill_vs_replay_capacity_unbounded_bf16"] = {
            "positions": check_len, "rel_l2": rel_l2(got, want),
            "routing_flip_share_by_layer": routing_flips(
                pre, rep, batch, cfg.n_layers)}
        del pre, rep

        f32 = dataclasses.replace(unbounded, param_dtype="float32",
                                  n_layers=check_layers)
        fm = build_model(f32)
        p32 = fm.init(torch.Generator("cuda").manual_seed(1))
        want = decode_replay(fm, p32, short["tokens"], check_len)[:, -1]
        err = rel_l2(fm.prefill(p32, short)[0][:, 0], want)
        check = {"dtype": "float32", "layers": check_layers,
                 "positions": check_len, "capacity_factor":
                 f32.capacity_factor, "rel_l2": err, "tol": SERVE_REL_L2}
        require(err <= SERVE_REL_L2, f"{cfg.name}: float32 prefill's last "
                f"logits off the replay's by {err} (relative L2, capacity "
                "unbounded)")
        with moe_fault("gates_not_renormalised"):
            raw = fm.prefill(p32, short)[0][:, 0]
        for name, bad in (("one_token_short", fm.prefill(
                p32, {"tokens": short["tokens"][:, :-1]})[0][:, 0]),
                ("gates_not_renormalised", raw)):
            check[f"fault_{name}_rel_l2"] = rel_l2(bad, want)
            require(check[f"fault_{name}_rel_l2"] > SERVE_REL_L2,
                    f"{cfg.name}: the prefill/replay check accepts a fault "
                    f"({name})")
        out["prefill_vs_replay_check"] = check
        del p32
        torch.cuda.empty_cache()
        out["decode_step_profile"] = profile_decode_step(
            model, params, out, batch, prompt, new, model_labels())
    return out, launches


def warm_stats(res, batch: int, seq: int) -> dict:
    """Step times of a train_loop result, step 0 (the warm-up) left out."""
    warm = list(range(1, len(res.step_s)))
    local = [1e3 * res.step_s[i] for i in warm if i not in res.sync_steps]
    sync = [1e3 * res.step_s[i] for i in warm if i in res.sync_steps]
    return {"step_ms": [1e3 * s for s in res.step_s],
            "local_step_ms_median": statistics.median(local),
            "sync_step_ms_median": statistics.median(sync),
            "tokens_per_s_warm": batch * seq * len(warm)
            / sum(res.step_s[i] for i in warm)}


def baseline_stats(res, batch: int, seq: int) -> dict:
    """Step times of a synchronous run (every step applies the gradient),
    step 0 (the warm-up) left out."""
    warm = res.step_s[1:]
    return {"step_ms": [1e3 * s for s in res.step_s],
            "step_ms_median_warm": 1e3 * statistics.median(warm),
            "tokens_per_s_warm": batch * seq * len(warm) / sum(warm)}


def state_digests(directory: Path) -> dict:
    """sha256 of every array of the latest checkpoint under ``directory``
    (each array read in turn, the hashes computed side by side on
    threads: hashlib lets go of the interpreter over large buffers)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from repro_torch.checkpoint import latest_step
    step = latest_step(str(directory))
    digest = lambda a: hashlib.sha256(
        np.ascontiguousarray(a).view(np.uint8)).hexdigest()
    with np.load(directory / f"step_{step}" / "arrays.npz") as z, \
            ThreadPoolExecutor(max_workers=8) as pool:
        futures = {k: pool.submit(digest, z[k]) for k in z.files}
        return {k: f.result() for k, f in futures.items()}


def timed_checkpoints():
    """Wrap the checkpoint store's save and restore (train_loop looks them
    up on each call) to time them; returns the lists of seconds."""
    from repro_torch import checkpoint as ck
    times = {"save_s": [], "restore_s": []}
    for name, key in (("save_checkpoint", "save_s"),
                      ("restore_checkpoint", "restore_s")):
        fn = getattr(ck, name)

        def timed(*args, _fn=fn, _key=key, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            times[_key].append(time.perf_counter() - t0)
            return out
        setattr(ck, name, timed)
    return times


def resume_matches(cfg, shape, oc, root: Path, tag: str, *, save_at: int,
                   steps: int, n_workers: int, resume_oc=None) -> dict:
    """A run straight to ``steps`` against ``save_at`` steps, a checkpoint,
    and a fresh train_loop resuming to ``steps`` (in ``resume_oc``'s
    layout, if given): losses and the final state (the checkpoint each run
    writes at ``steps``) must be bitwise equal when the layouts agree, the
    losses within 1e-6 relative across layouts."""
    import shutil
    from repro_torch.launch.train import train_loop
    straight_dir, resumed_dir = root / (tag + "_straight"), root / tag
    straight = train_loop(cfg, shape, resume_oc or oc, steps=steps,
                          n_workers=n_workers, verbose=False, device="cuda",
                          checkpoint_dir=str(straight_dir),
                          checkpoint_every=steps)
    want = state_digests(straight_dir)
    shutil.rmtree(straight_dir)
    first = train_loop(cfg, shape, oc, steps=save_at, n_workers=n_workers,
                       verbose=False, device="cuda",
                       checkpoint_dir=str(resumed_dir),
                       checkpoint_every=save_at)
    ckpt_bytes = sum(f.stat().st_size for f in
                     (resumed_dir / f"step_{save_at}").iterdir())
    resumed = train_loop(cfg, shape, resume_oc or oc, steps=steps,
                         n_workers=n_workers, verbose=False, device="cuda",
                         checkpoint_dir=str(resumed_dir),
                         checkpoint_every=steps)
    got = state_digests(resumed_dir)
    shutil.rmtree(resumed_dir)
    require(resumed.start_step == save_at,
            f"{tag}: resumed at {resumed.start_step}, want {save_at}")
    tail = straight.losses[save_at:]
    if resume_oc is None:
        require(first.losses + resumed.losses == straight.losses,
                f"{tag}: resumed losses {resumed.losses} differ from the "
                f"straight run's {tail}")
        require(first.sync_steps + resumed.sync_steps == straight.sync_steps,
                f"{tag}: schedule {first.sync_steps} + {resumed.sync_steps}"
                f" vs {straight.sync_steps}")
    else:
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, tail))
        require(rel <= 1e-6, f"{tag}: resumed losses {resumed.losses} vs "
                f"{tail} ({rel} relative)")
        require(resumed.sync_steps == straight.sync_steps[
            len(first.sync_steps):], f"{tag}: schedule {resumed.sync_steps}")
    require(got == want, f"{tag}: final state differs from the straight "
            f"run's in {sorted(k for k in want if got.get(k) != want[k])}")
    return {"losses_straight": straight.losses,
            "losses_resumed": resumed.losses,
            "sync_steps": straight.sync_steps,
            "state_leaves_bitwise": len(want), "checkpoint_bytes": ckpt_bytes}


def require_launches(launches, **want) -> dict:
    """``launches`` (counter name -> count) equal to ``want``, 0 where
    ``want`` names no count."""
    full = {k: want.get(k, 0) for k in launches}
    require(launches == full, f"launches {launches}, expected {full}")
    return launches


def read_counts(counters) -> dict:
    """Each kernel wrapper's launch count, by counter name."""
    return {k: c.n for k, c in counters.items()}


def baselines_phase(cfg, shape, small, base, counters, leaf) -> dict:
    """The synchronous baselines (sgd, adagrad, adaalter): reduced float32
    AdaAlter card against CPU (lr 2: an η 2% larger on the CPU must leave
    the tolerance), then each at full width through train_loop, R = 1, the
    train phase's global batch in one model, no kernel launched; one
    profiled AdaAlter step."""
    import torch
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.models.counting import count_params
    rtol = 1e-4
    small_shape = ShapeConfig("smoke", seq_len=16, global_batch=8,
                              kind="train")

    def reduced_losses(dev, lr):
        res = train_loop(small, small_shape,
                         OptimizerConfig(name="adaalter", lr=lr,
                                         warmup_steps=0),
                         steps=TRAIN_STEPS, verbose=False, device=dev,
                         init_params=base)
        require(res.sync_steps == list(range(TRAIN_STEPS)),
                f"reduced adaalter on {dev}: rounds at {res.sync_steps}")
        return res.losses

    cuda, cpu = reduced_losses("cuda", 2.0), reduced_losses("cpu", 2.0)
    rel = max_rel(cuda, cpu)
    rel_wrong = max_rel(reduced_losses("cpu", 2.0 * 1.02), cpu)
    require(rel <= rtol, f"reduced adaalter: losses differ by {rel}")
    require(rel_wrong > rtol, f"reduced adaalter: an η 2% off moves the "
            f"losses by only {rel_wrong}, within the tolerance")
    n_params, V = count_params(cfg), cfg.vocab_size
    batch, seq = shape.global_batch, shape.seq_len
    runs = {}
    for name in ("sgd", "adagrad", "adaalter"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        res = train_loop(cfg, shape, OptimizerConfig(
            name=name, lr=0.5, warmup_steps=100), steps=TRAIN_STEPS,
            log_every=1, device="cuda")
        launches = require_launches(read_counts(counters))  # plain ops
        require(res.n_workers == 1 and res.sync_count == TRAIN_STEPS,
                f"{name}: {res.n_workers} workers, {res.sync_count} rounds")
        require(all(math.isfinite(v) for v in res.losses),
                f"{name}: non-finite loss {res.losses}")
        require(abs(res.losses[0] - math.log(V)) <= 1.5,
                f"{name}: step-0 loss {res.losses[0]} vs ln V {math.log(V)}")
        require(res.comm_bytes_total == TRAIN_STEPS * 4 * n_params,
                f"{name}: comm_bytes_total {res.comm_bytes_total}")
        runs[name] = {"losses": res.losses, "launches": launches,
                      "comm_bytes_total": res.comm_bytes_total,
                      **baseline_stats(res, batch, seq),
                      "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    prof = profile_steps(lambda: train_loop(
        cfg, shape, OptimizerConfig(name="adaalter", lr=0.5,
                                    warmup_steps=100),
        steps=3, verbose=False, device="cuda"))
    require([p["step"] for p in prof] == [f"train_step {i} sync"
                                          for i in range(3)],
            f"the profiler saw steps {[p['step'] for p in prof]}")
    for p in prof:
        p["device_idle_share_vs_unprofiled_wall"] = 1.0 - p[
            "device_busy_ms"] / runs["adaalter"]["step_ms_median_warm"]
    return {"arch": cfg.name, "params": n_params, "workers": 1,
            "global_batch": batch, "seq": seq, "steps": TRAIN_STEPS,
            "note": "one card: no collective runs, so these walls hold no "
                    "communication; comm_bytes_total is what a P-value fp32 "
                    "gradient all-reduce a step would move",
            "reduced_adaalter": {"rtol": rtol, "losses_cuda": cuda,
                                 "losses_cpu": cpu, "max_rel_diff": rel,
                                 "max_rel_diff_eta_2pct_high": rel_wrong},
            "runs": runs,
            "local_adaalter_per_leaf": {
                k: leaf[k] for k in ("local_step_ms_median",
                                     "sync_step_ms_median",
                                     "tokens_per_s_warm",
                                     "max_memory_allocated_gb")},
            "profile_adaalter": prof[1:]}


def checkpoint_phase(cfg, shape, workers: int) -> dict:
    """Resumes bitwise equal to the straight run: full-width AdaAlter
    (R = 1; bf16 params and fp32 B² on disk), with the save and restore
    seconds; reduced Big LSTM on the card, Local AdaAlter with the int8
    kernels and the adaptive policy, per leaf and flat, mid-window; and a
    per-leaf checkpoint resumed over the flat plane (fixed H). The
    checkpoints go to a temporary directory, removed at the end."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import OptimizerConfig, ShapeConfig, reduced
    from repro_torch.models.counting import count_params
    n_params = count_params(cfg)
    times = timed_checkpoints()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        # two checkpoints of bf16 params + fp32 B² on disk at once
        need = 2 * 6 * n_params + 1e9
        free = shutil.disk_usage(root).free
        require(free >= need, f"checkpoint phase: {free / 1e9:.1f} GB free "
                f"under {root}, {need / 1e9:.1f} GB needed")
        torch.cuda.empty_cache()
        full = resume_matches(cfg, shape, OptimizerConfig(
            name="adaalter", lr=0.5, warmup_steps=100), root, "full",
            save_at=TRAIN_STEPS // 2, steps=TRAIN_STEPS, n_workers=1)
        full.update(save_s=list(times["save_s"]),
                    restore_s=list(times["restore_s"]))
        small = reduced(cfg)                 # bf16, as the full model
        small_shape = ShapeConfig("smoke", seq_len=16, global_batch=8,
                                  kind="train")
        adaptive = dict(name="local_adaalter", compression="int8",
                        use_kernels=True, H=4, lr=0.5, warmup_steps=0,
                        sync_policy="adaptive", sync_threshold=0.002)
        fixed = dict(adaptive, sync_policy="fixed_h")
        small_runs = {
            name: resume_matches(
                small, small_shape, OptimizerConfig(**kw), root, name,
                save_at=5, steps=9, n_workers=workers,
                resume_oc=None if rkw is None else OptimizerConfig(**rkw))
            for name, kw, rkw in (
                ("per_leaf", adaptive, None),
                ("flat", dict(adaptive, flat=True), None),
                ("per_leaf_to_flat", fixed, dict(fixed, flat=True)))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"full": {"optimizer": "adaalter", "params": n_params, **full},
            "reduced": small_runs}


def instrumented_phase(cfg, shape, oc, counters, leaf, leaf_n,
                       workers: int) -> dict:
    """The train phase's per-leaf run with trace_out and metrics_out: the
    same launches, one metrics row a step, the residual fields appearing at
    the first sync round and changing only on sync rounds, the span counts,
    the replay gate, the Chrome export; step walls and the probe's seconds
    beside the uninstrumented run's. The trace carries the steps' cost
    tables (``meta["hlo_cost"]``): their FLOPs and bytes must equal a walk
    of the same programs on the meta device, the local steps' spans carry
    ``hlo_optimal_s`` and the encode spans ``hlo_extra_optimal_s``; the
    replay priced from the tables gives its predicted / warm-wall ratio
    (reported, not gated), and the gate holds the trace without them (the
    warm means) as before."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.steps import build_train_programs
    from repro_torch.launch.train import step_cost_tables, train_loop
    from repro_torch.trace import Trace
    from repro_torch.trace.chrome import export
    from repro_torch.trace.replay import validate
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t_path, m_path = root / "run.trace.json", root / "run.jsonl"
        res = train_loop(cfg, shape, oc, steps=TRAIN_STEPS,
                         n_workers=workers, verbose=False, device="cuda",
                         trace_out=str(t_path), metrics_out=str(m_path))
        launches = require_launches(read_counts(counters), **leaf_n)
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(peak < 80.0, f"instrumented run peak {peak} GB")
        require(res.sync_steps == [3, 7], f"sync steps {res.sync_steps}")
        rows = [json.loads(line) for line in
                m_path.read_text().splitlines()]
        require([r["step"] for r in rows[1:]] == list(range(TRAIN_STEPS)),
                f"{len(rows)} metrics lines")
        keys = [sorted(k for k in r["metrics"] if k.startswith(
            ("ef_residual_norm", "quant_mse"))) for r in rows[1:]]
        vals = [[r["metrics"][k] for k in ks]
                for r, ks in zip(rows[1:], keys)]
        require(not any(keys[:3]) and all(keys[3:]),
                f"residual fields by step {keys}")
        require(vals[3] == vals[4] == vals[5] == vals[6] != vals[7],
                f"residual values by step {vals}")
        trace = Trace.load(str(t_path))
        counts = {k: len(trace.by_name(k)) for k in
                  ("local_step", "ef_encode", "collective", "eval", "ckpt")}
        require(counts == {"local_step": workers * TRAIN_STEPS,
                           "ef_encode": workers * 2,
                           "collective": workers * 2, "eval": 0, "ckpt": 0},
                f"span counts {counts}")
        tables = trace.meta.get("hlo_cost")
        require(isinstance(tables, dict) and set(tables) == {
            "local_step", "sync_step", "hw"}, "the card's trace carries no "
            f"cost table: {sorted(trace.meta)}")
        oc_obs = dataclasses.replace(oc, obs_metrics=True)
        tok = torch.empty((workers, shape.global_batch // workers,
                           shape.seq_len), dtype=torch.int32, device="meta")
        want = step_cost_tables(cfg, oc_obs, build_train_programs(
            cfg, oc_obs, n_workers=workers, device="meta"),
            {"tokens": tok, "labels": tok})
        same = {k: (tables[k]["flops"], tables[k]["bytes"]) == (
            want[k]["flops"], want[k]["bytes"])
            for k in ("local_step", "sync_step")}
        require(all(same.values()), f"the trace's cost tables differ from "
                f"the meta walk's: {same}")
        require(all("hlo_optimal_s" in s.args
                    for s in trace.by_name("local_step"))
                and all("hlo_extra_optimal_s" in s.args
                        for s in trace.by_name("ef_encode")),
                "the spans lack the tables' optimal walls")
        priced = validate(trace)
        require(priced["priced_from"] == "hlo_regions",
                f"the replay did not price from the tables: {priced}")
        del trace.meta["hlo_cost"]
        gate = validate(trace)
        require(gate["ok"], f"replay gate: {gate}")
        doc = export(str(t_path), str(root / "run.chrome.json"))
        return {"launches": launches, "span_counts": counts,
                "validate": gate, "validate_priced_from_tables": priced,
                "cost_tables": {k: {f: tables[k][f] for f in (
                    "flops", "bytes", "optimal_s", "n_regions")}
                    for k in ("local_step", "sync_step")},
                "cost_tables_equal_meta_walk": same,
                "chrome_events": len(doc["traceEvents"]),
                "chrome_bytes": (root / "run.chrome.json").stat().st_size,
                "metrics_rows": len(rows) - 1,
                "probe_ms": [1e3 * t for t in res.probe_s],
                **warm_stats(res, shape.global_batch, shape.seq_len),
                "uninstrumented_local_step_ms_median":
                    leaf["local_step_ms_median"],
                "uninstrumented_sync_step_ms_median":
                    leaf["sync_step_ms_median"],
                "max_memory_allocated_gb": peak,
                "last_row": {k: v for k, v in rows[-1]["metrics"].items()
                             if k.startswith(("b2", "grad_norm", "ef_",
                                              "quant", "loss"))}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def slice6_phases(counters, smi: str) -> None:
    """The MoE, VLM and encoder-decoder phases: scoring and serving at full
    width, each freeing its weights before the next loads (their reduced
    card-vs-CPU checks ran beside the examples). Every kernel counter must
    read 0."""
    import torch
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import SyntheticLM, make_train_batch
    from repro_torch.models import build_model

    # phi3.5-moe at full width, MOE_LAYERS of its 32 layers (one card)
    t0 = time.perf_counter()
    phi = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"),
                              n_layers=MOE_LAYERS)
    params = build_model(phi).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.empty_cache()
    score, n = moe_score_phase(phi, params, counters)
    require_launches(n)
    emit({"phase": "score_moe", "nvidia_smi": smi, "layers": MOE_LAYERS,
          "layers_of_config": get_arch("phi3.5-moe-42b-a6.6b").n_layers,
          **score, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    serve, n = serve_moe(phi, params, counters, batch=8, prompt=SERVE_PROMPT,
                         new=32)
    require_launches(n)
    emit({"phase": "serve_moe", "nvidia_smi": smi, "layers": MOE_LAYERS,
          **serve, "seconds": time.perf_counter() - t0})
    del params
    free_card()

    # llama-3.2-vision-11b and seamless-m4t-large-v2 at full width, their
    # depth cut (DEPTH_CUTS)
    for phase, arch in (("vlm", "llama-3.2-vision-11b"),
                        ("audio", "seamless-m4t-large-v2")):
        t0 = time.perf_counter()
        full = dataclasses.replace(get_arch(arch), **DEPTH_CUTS[arch])
        model = build_model(full)
        params = model.init(torch.Generator("cuda").manual_seed(0))
        if full.cross_attn_every:
            params = set_gates(params, CROSS_GATE)
        torch.cuda.empty_cache()
        stubs = make_train_batch(full, ShapeConfig(
            "score", seq_len=4096, global_batch=2, kind="train"),
            SyntheticLM(vocab_size=full.vocab_size, seq_len=4096, seed=0), 0)
        extra = {k: torch.from_numpy(v).cuda() for k, v in stubs.items()
                 if k in ("image_embeds", "audio_frames")}
        score, n = score_model(full, params, counters, batch=2, seq=4096,
                               ssd_calls=0, extra=extra,
                               labels=model_labels())
        require_launches(n)
        emit({"phase": f"score_{phase}", "nvidia_smi": smi,
              "depth": DEPTH_CUTS[arch],
              "cross_keys": {k: v.shape[1] for k, v in extra.items()},
              **score, "seconds": time.perf_counter() - t0})
        del extra
        t0 = time.perf_counter()
        faults = {"one_token_short": lambda p: model.prefill(
            params, prefill_batch(full, p[:, :-1]))[0]}
        reported = {"scores_scaled_2pct": lambda p: model.prefill(
            scaled_queries(params, 1.02), prefill_batch(full, p))[0]}
        if full.n_kv_heads < full.n_heads:
            # (with as many KV heads as heads the fault rotates the keys too)
            faults["queries_rotated_one_ahead"] = lambda p: rotated_prefill(
                model, params, p)
        serve, n = serve_model(full, params, counters, faults, batch=8,
                               prompt=SERVE_PROMPT, new=32,
                               reported=reported, labels=model_labels())
        require_launches(n)
        emit({"phase": f"serve_{phase}", "nvidia_smi": smi, **serve,
              "seconds": time.perf_counter() - t0})
        del params, model, faults, reported
        free_card()


def hybrid_fault(params, name: str):
    """Faulty parameters of the hybrid layer, each the exact function of a
    wrong fusion: ``ssm_dropped`` (norm_ssm at 0: the SSM half adds
    nothing) and ``sum_fusion`` (norm_attn and norm_ssm doubled: 0.5 ·
    (2a + 2s) is the sum a + s in place of the mean)."""
    scale = {"ssm_dropped": {"norm_ssm": 0.0},
             "sum_fusion": {"norm_attn": 2.0, "norm_ssm": 2.0}}[name]
    return {**params, "blocks": [
        {**b, **{k: b[k] * v for k, v in scale.items()}}
        for b in params["blocks"]]}


def hybrid_labels() -> dict:
    """The hybrid layer's parts for ``profile_call``: its self-attention,
    the SSM mixer (forward and decode) and, inside it, the SSD kernel's
    wrapper, and the MLP."""
    from repro_torch.models import ssm
    labels = model_labels()
    return {"self_attention": labels["self_attention"],
            "ssm": [(ssm, "ssm_forward"), (ssm, "ssm_decode_step")],
            "ssd_kernel": [(ssm, "ssd_scan")], "mlp": labels["mlp"]}


def reference_hybrid(counters) -> dict:
    """Reduced hymba (2 layers, window 64, 16 SSM heads of 32, state 16) in
    float32 with ssm_pallas, card against CPU with the same weights (as
    reference_moe compares them): logits_fn and loss_fn through the SSD
    kernel on the card (2 calls a layer) and its plain version on the
    CPU, prefill caches, decode steps after the prefill. On the card, the
    prompt of 96 positions replayed through decode_step over a ring of 64
    slots (the window: the ring wraps) against logits_fn at every position
    (the forward is windowed at 64 too) and against the prefill's last
    logits. The SSM half dropped and the mean fusion replaced by a sum must
    fail the card-vs-CPU check; those two and a prefill one token short
    must fail the prefill-vs-replay check."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced(get_arch("hymba-1.5b")),
                              param_dtype="float32", ssm_pallas=True)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(5))
    card = tree_map(lambda t: t.cuda(), cpu)
    B, L, n_dec, W = 2, 96, 8, cfg.sliding_window
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=L + n_dec, seed=1).worker_batch(
            0, 0, B).items()}
    what = "reduced hymba"
    out = {"arch": cfg.name, "batch": B, "seq": L, "window": W,
           "ssm_heads": cfg.n_ssm_heads, "rtol": MODEL_RTOL,
           "atol": MODEL_ATOL}
    for c in counters.values():
        c.reset()
    with torch.inference_mode():
        rep, lg_card, lg_cpu = card_vs_cpu(model, card, cpu, batch, L, n_dec,
                                           what)
        out.update(rep)
        out["launches"] = require_launches(read_counts(counters),
                                           ssd_scan=2 * cfg.n_layers)
        tokens = batch["tokens"][:, :L].cuda()
        replay = decode_replay(model, card, tokens, W, window=W)
        out["replay_vs_logits_fn_max_abs_err"] = require_close(
            replay, lg_card, f"{what}: replay over a ring of {W} vs "
            "logits_fn")
        want = replay[:, -1]
        out["prefill_vs_replay_max_abs_err"] = require_close(
            model.prefill(card, {"tokens": tokens})[0][:, 0], want,
            f"{what}: prefill's last logits vs the replay's")
        for name in ("ssm_dropped", "sum_fusion"):
            bad = hybrid_fault(card, name)
            out[f"fault_{name}_vs_cpu_max_abs_err"] = fault_rejected(
                model.logits_fn(bad, {"tokens": tokens}), lg_cpu,
                f"{what}: {name}")
            out[f"fault_{name}_vs_replay_max_abs_err"] = fault_rejected(
                model.prefill(bad, {"tokens": tokens})[0][:, 0], want,
                f"{what}: {name} prefill")
        out["fault_one_token_short_vs_replay_max_abs_err"] = fault_rejected(
            model.prefill(card, {"tokens": tokens[:, :-1]})[0][:, 0], want,
            f"{what}: prefill one token short")
    return out


def reference_train_families(counters) -> dict:
    """Reduced float32 hymba, qwen2-7b and phi3.5-moe through train_loop:
    Local AdaAlter, 2 workers, H = 4, int8 wire, 8 steps at lr 2, the card
    with the kernels against the CPU with their plain versions, same
    initial weights: losses to rtol 1e-4, which the CPU run with η 2%
    larger must exceed; sync steps and comm bytes exactly equal; the card's
    launches of the fused update and the EF encode one per leaf a step and
    two per leaf a round. The CPU runs ran beside the examples
    (SIDE["train_families"])."""
    from repro_torch.configs import get_arch, reduced
    rtol, lr = 1e-4, REFERENCE_LR
    out = {"rtol": rtol, "lr": lr, "steps": TRAIN_STEPS, "workers": 2,
           "runs": {}}
    for arch in TRAIN_FAMILIES:
        cfg = reduced(get_arch(arch))
        for c in counters.values():
            c.reset()
        cuda, n_leaves = family_run(arch, "cuda", lr)
        launches = require_launches(
            read_counts(counters), adaalter_update=n_leaves * TRAIN_STEPS,
            fused_ef=2 * n_leaves * 2)
        cpu = SIDE["train_families"][arch]
        for key in ("sync_steps", "comm_bytes_total", "comm_bytes_modeled"):
            require(getattr(cuda, key) == cpu[key],
                    f"reduced {arch}: {key} {getattr(cuda, key)} on the "
                    f"card, {cpu[key]} on the CPU")
        require(cuda.sync_steps == [3, 7], f"reduced {arch}: sync steps "
                f"{cuda.sync_steps}")
        rel, rel_wrong = (max_rel(cuda.losses, cpu["losses"]),
                          max_rel(cpu["losses_eta_2pct_high"],
                                  cpu["losses"]))
        require(all(math.isfinite(x) for x in cuda.losses),
                f"reduced {arch}: non-finite loss {cuda.losses}")
        require(rel <= rtol, f"reduced {arch}: losses differ by {rel} "
                "relative")
        require(rel_wrong > rtol, f"reduced {arch}: an η 2% off moves the "
                f"losses by only {rel_wrong}, within the tolerance")
        out["runs"][cfg.name] = {
            "leaves": n_leaves, "losses_cuda": cuda.losses,
            "losses_cpu": cpu["losses"], "max_rel_diff": rel,
            "max_rel_diff_eta_2pct_high": rel_wrong,
            "sync_steps": cuda.sync_steps,
            "comm_bytes_total": cuda.comm_bytes_total, "launches": launches}
    return out


def hymba_train_cfg():
    """hymba-1.5b at full width, cut to HYMBA_TRAIN_LAYERS of its 32
    layers: two workers' parameters, B², EF residuals and gradients of all
    32 (1.64 G parameters) would not fit one card, and the script's time
    budget takes the rest."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("hymba-1.5b"),
                               n_layers=HYMBA_TRAIN_LAYERS)


def train_hybrid(cfg, counters, smi, *, steps, flat):
    """train_loop on ``cfg`` (hymba at full width, cut in depth): bf16, 2
    workers stacked on the card, 4 sequences of 512 tokens each, Local
    AdaAlter H = 4, int8 wire, kernels on; every launch count set to 0 just
    before and read just after. Finite losses, step 0 within 1.5 nats of
    ln V. Returns (report, launches)."""
    import torch
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.models.counting import count_params
    R, batch, seq = 2, 8, 512
    shape = ShapeConfig("hybrid", seq_len=seq, global_batch=batch,
                        kind="train")
    oc = OptimizerConfig(name="local_adaalter", lr=0.5, H=4,
                         warmup_steps=100, compression="int8",
                         use_kernels=True, flat=flat)
    free_card()
    for c in counters.values():
        c.reset()
    res = train_loop(cfg, shape, oc, steps=steps, n_workers=R, log_every=1,
                     device="cuda")
    launches = read_counts(counters)
    require(res.sync_steps == [3, 7][:steps // 4],
            f"{cfg.name}: sync steps {res.sync_steps} (flat={flat})")
    require(all(math.isfinite(v) for v in res.losses),
            f"{cfg.name}: non-finite loss (flat={flat})")
    require(abs(res.losses[0] - math.log(cfg.vocab_size)) <= 1.5,
            f"{cfg.name}: step-0 loss {res.losses[0]} vs ln V "
            f"{math.log(cfg.vocab_size)}")
    out = {"nvidia_smi": smi, "arch": cfg.name, "layers": cfg.n_layers,
           "params": count_params(cfg), "workers": R,
           "global_batch": batch, "seq": seq, "steps": steps, "flat": flat,
           "losses": res.losses, "sync_steps": res.sync_steps,
           "launches": launches, **warm_stats(res, batch, seq),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "comm_bytes_total": res.comm_bytes_total}
    require(out["max_memory_allocated_gb"] < 80.0,
            f"{cfg.name} training peak {out['max_memory_allocated_gb']} GB")
    if not flat:       # where a step's time goes: 4 more steps, profiled
        prof = profile_steps(lambda: train_loop(
            cfg, shape, oc, steps=4, n_workers=R, verbose=False,
            device="cuda"))
        for p in prof:
            p["device_idle_share_vs_unprofiled_wall"] = 1.0 - p[
                "device_busy_ms"] / out["sync_step_ms_median" if p[
                    "step"].endswith("sync") else "local_step_ms_median"]
        out["profile"] = prof[1:]
    return out, launches


def slice7_phases(counters, smi: str) -> dict:
    """The hybrid family (its reduced card-vs-CPU checks, of the model and
    of training three families, ran beside the examples): hymba-1.5b
    scored and served at full width
    and depth, the SSD kernel on the scoring forward (one call a layer, 50
    heads) and on no serving path; hymba at full width and
    HYMBA_TRAIN_LAYERS of its 32 layers trained per leaf and over the flat plane. Returns the launch
    counts of the full-width runs by phase."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    config_layers = get_arch("hymba-1.5b").n_layers
    hymba = dataclasses.replace(get_arch("hymba-1.5b"), ssm_pallas=True,
                                **DEPTH_CUTS["hymba-1.5b"])
    model = build_model(hymba)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    score, score_n = score_model(hymba, params, counters, batch=2, seq=4096,
                                 ssd_calls=hymba.n_layers,
                                 labels=hybrid_labels())
    require_launches(score_n, ssd_scan=2 * 3 * hymba.n_layers)
    emit({"phase": "score_hybrid", "nvidia_smi": smi,
          "ssm_heads": hymba.n_ssm_heads, "layers": hymba.n_layers, **score,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    serve, serve_n = serve_model(hymba, params, counters, {
        "one_token_short": lambda p: model.prefill(
            params, {"tokens": p[:, :-1]})[0]}, batch=8,
        prompt=SERVE_PROMPT, new=32, reported={
            name: (lambda p, _n=name: model.prefill(
                hybrid_fault(params, _n), {"tokens": p})[0])
            for name in ("ssm_dropped", "sum_fusion")},
        labels=hybrid_labels(), replay=HYBRID_SERVE_REPLAY)
    require_launches(serve_n)
    emit({"phase": "serve_hybrid", "nvidia_smi": smi,
          "window": hymba.sliding_window, **serve,
          "seconds": time.perf_counter() - t0})
    del params, model
    free_card()

    short = hymba_train_cfg()
    n_leaves = len(leaves(build_model(short).init(None, "meta")))
    t0 = time.perf_counter()
    leaf, leaf_n = train_hybrid(short, counters, smi, steps=TRAIN_STEPS,
                                flat=False)
    require_launches(leaf_n, adaalter_update=n_leaves * TRAIN_STEPS,
                     fused_ef=2 * n_leaves * 2)
    emit({"phase": "train_hybrid", "layers_of_config": config_layers,
          **leaf, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    flat, flat_n = train_hybrid(short, counters, smi, steps=TRAIN_STEPS,
                                flat=True)
    # one update launch a step; one EF launch per payload half per round
    require_launches(flat_n, flat_fused_update=TRAIN_STEPS, flat_ef=2 * 2)
    # the same weights and batches: the flat run's kernels must leave the
    # per-leaf run's losses, a sync round's included, bit for bit
    require(flat["losses"] == leaf["losses"],
            f"{short.name}: flat losses {flat['losses']} differ from the "
            f"per-leaf run's {leaf['losses']}")
    flat["losses_equal_per_leaf"] = True
    emit({"phase": "train_hybrid_flat", "layers_of_config": config_layers,
          **flat, "seconds": time.perf_counter() - t0})
    free_card()
    t0 = time.perf_counter()
    remat, remat_n = train_hybrid_remat(short, counters, smi, leaf, n_leaves)
    emit({"phase": "train_hybrid_remat", "layers_of_config": config_layers,
          **remat, "seconds": time.perf_counter() - t0})
    free_card()
    return {"score_hybrid": score_n, "train_hybrid": leaf_n,
            "train_hybrid_flat": flat_n, "train_hybrid_remat": remat_n}


# train_loop runs as gloo ranks on the card, one process group (one launch)
# for all: a run's plan may be given (the CLI has no --plan); rank 0 writes
# the results
# the modules a rank program's first run would load (a launch held for its
# go has them loaded before it)
WARM_IMPORTS = r"""
import torch._dynamo
import repro_torch.kernels.ops, repro_torch.launch.steps
import repro_torch.obs.health, repro_torch.obs.metrics
"""
# a rank's loop over training runs (dicts of arch, reduced, dtype, workers,
# opt, plan, steps, batch, seq, a depth cut: layers; record_routing), a
# train_loop a run with the card's memory freed and its peak reset before
# each; rank 0 prints a line as each run ends (torchrun_train's marks)
RANK_LOOPS_HEAD = r"""
import contextlib, dataclasses, gc, json, os, statistics, sys, time
import torch
import torch.distributed as dist
from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh
from repro_torch.launch.serve import serve_session
from repro_torch.launch.serving import build_serve_programs, decode_cache_specs
from repro_torch.launch.train import train_loop
from repro_torch.models import attention, build_model, layers
from repro_torch.sharding import GridLayout
from repro_torch.tree import leaves, tree_map
""" + WARM_IMPORTS + "\n".join(inspect.getsource(f) for f in (require, pin_routing)) + r"""

def run_loops(runs):
    out = []
    for run in runs:
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = get_arch(run["arch"])
        cfg = reduced(cfg) if run.get("reduced") else cfg
        if run.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=run["layers"])
        if run.get("dtype"):
            cfg = dataclasses.replace(cfg, param_dtype=run["dtype"])
        shape = ShapeConfig("ranks", seq_len=run["seq"],
                            global_batch=run["batch"], kind="train")
        plan = ParallelismPlan(**run["plan"]) if run.get("plan") else None
        # record_routing: the MoE's choices kept, for a one-rank run to
        # replay
        routing = [] if run.get("record_routing") else None
        with (pin_routing(record=routing) if routing is not None
              else contextlib.nullcontext()):
            r = train_loop(cfg, shape, OptimizerConfig(**run["opt"]),
                           steps=run["steps"], seed=0, verbose=False,
                           group=group, n_workers=run.get("workers", 1),
                           device=str(dev), digest=True, plan=plan)
        out.append(dataclasses.asdict(r))
        if routing is not None:
            out[-1]["routing"] = [t.tolist() for t in routing]
        if group.rank == 0:
            print(f"chip_smoke: run {cfg.name} {run['steps']} steps "
                  f"{time.perf_counter() - t0:.3f} s, train_loop "
                  f"{r.wall_s:.3f} s", flush=True)
    return out

spec = json.load(open(sys.argv[1]))
if os.environ.get("RANK") == "0":
    print("chip_smoke: imported", flush=True)
while spec["go"] and not os.path.exists(spec["go"]):
    time.sleep(0.05)
group, dev = mesh.init_ranks("gloo", None, grid=spec["grid"])
if group.rank == 0:
    print("chip_smoke: ready", flush=True)
out = {"runs": run_loops(spec["runs"])}
"""
RANK_TAIL = r"""
mesh.close_ranks()
if group.rank == 0:
    json.dump(out, open(sys.argv[2], "w"))
"""


# every torchrun launch so far: its wall from its go, the seconds from its
# start at which its ranks had imported what they run and stood ready
# (process group opened, CUDA context), and its marked lines
LAUNCHES = []


def start_launch(root: Path, args=(), *, nproc: int = 2, script=None,
                 spec=None, what: str = "", hold: bool = False) -> dict:
    """Start ``python -m torch.distributed.run --standalone
    --nproc-per-node <nproc>``: ``nproc`` ranks on the one card, as a
    subprocess in a session of its own (killed at the script's exit if it
    is still running), running ``-m repro_torch.launch.train --dist-backend
    gloo <args>``, or with ``script`` (a rank's program: ``script
    spec.json result.json``) that program on ``spec``. With ``hold`` (a
    program's launch) its ranks import what they run and then wait, before
    they open the process group or touch the card, for
    :func:`finish_launch`'s go: a launch started while nothing is timed
    has its start-up behind it when its phase begins. Rank 0's lines are
    read as they come, each with its second since the start."""
    import signal
    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name) / "result.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc)]
    if script is not None:
        path, spec_path = Path(tmp.name) / "rank.py", Path(tmp.name) / \
            "spec.json"
        go = Path(tmp.name) / "go"
        path.write_text(script)
        spec_path.write_text(json.dumps({**spec, "go": str(go) if hold
                                         else None}))
        cmd += [str(path), str(spec_path), str(out)]
    else:
        require(not hold, "a launch of the CLI is not held")
        cmd += ["-m", "repro_torch.launch.train", "--dist-backend", "gloo",
                "--out", str(out), *args]
    # two processes share the card: segments that grow in place keep each
    # allocator's cache from holding freed blocks the other needs
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "4",
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    t0 = time.perf_counter()
    log = open(Path(tmp.name) / "log.txt", "w")
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    # the launch's lines as they come, each with its second: where the
    # ranks finished their imports and stood ready (start-up) and where
    # each run ended (its work)
    marks = []

    def pump():
        for line in proc.stdout:
            log.write(line)
            if line.startswith(("chip_smoke: ", "training ", "done in ")):
                marks.append((time.perf_counter() - t0, line.strip()))
        log.close()
    reader = threading.Thread(target=pump, daemon=True)
    reader.start()

    def kill():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(kill)
    return {"tmp": tmp, "out": out, "proc": proc, "reader": reader,
            "marks": marks, "kill": kill, "t0": t0, "hold": hold,
            "what": what, "nproc": nproc, "args": args,
            "started_s": t0 - T_START}


def finish_launch(launch: dict, timeout: float = 420.0):
    """Let a launch :func:`start_launch` started run (its go, where it was
    held) and wait for it: killed past ``timeout`` seconds from then, the
    card's used memory sampled from nvidia-smi twice a second. Returns
    (what rank 0 wrote: the CLI's TrainResult as a dict, or a program's
    result; the wall seconds from the go; the peak MiB used on the card).
    The launch's files stay until ``launch["tmp"]`` is cleaned up."""
    proc, marks = launch["proc"], launch["marks"]
    t0 = time.perf_counter()
    if launch["hold"]:
        (Path(launch["tmp"].name) / "go").touch()
    peak = 0
    try:
        while proc.poll() is None:
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"chip_smoke: torchrun {launch['what']} "
                                   f"ran past {timeout} s")
            used = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30).stdout.split()
            peak = max([peak] + [int(v) for v in used[:1]])
            time.sleep(0.5)
    finally:
        launch["kill"]()
        launch["reader"].join(timeout=60)
    wall = time.perf_counter() - t0
    text = (Path(launch["tmp"].name) / "log.txt").read_text()
    require(proc.returncode == 0, f"torchrun {launch['what']} "
            f"{list(launch['args'])} exited {proc.returncode}:\n"
            f"{text[-4000:]}")
    first = lambda *tags: next((t for t, m in marks
                                if m.startswith(tags)), None)
    LAUNCHES.append({
        "what": launch["what"], "nproc": launch["nproc"],
        "started_s": launch["started_s"], "held": launch["hold"],
        "go_s": t0 - launch["t0"], "wall_s": wall,
        "imported_s": first("chip_smoke: imported"),
        "ready_s": first("chip_smoke: ready", "training "),
        "marks": [[t, m] for t, m in marks if not m.startswith(
            ("chip_smoke: ready", "chip_smoke: imported"))]})
    emit({"launch": LAUNCHES[-1]})
    return json.loads(launch["out"].read_text()), wall, peak


def torchrun_train(root: Path, args=(), *, nproc: int = 2,
                   timeout: float = 420.0, script=None, spec=None,
                   what: str = ""):
    """:func:`start_launch` and :func:`finish_launch` at once."""
    launch = start_launch(root, args, nproc=nproc, script=script, spec=spec,
                          what=what)
    try:
        return finish_launch(launch, timeout)
    finally:
        launch["tmp"].cleanup()


def same_run(a: dict, b: dict) -> bool:
    """Two training runs equal bit for bit: losses, schedule, comm bytes
    and the final state's digest."""
    return all(a[k] == b[k] for k in ("losses", "sync_steps",
                                      "comm_bytes_total", "state_digest"))


def rank_walls(rep: dict, sync_steps, steps: int) -> dict:
    """A rank's warm local and sync step medians (step 0 left out), ms."""
    warm = range(1, steps)
    local = [1e3 * rep["step_s"][i] for i in warm if i not in sync_steps]
    sync = [1e3 * rep["step_s"][i] for i in warm if i in sync_steps]
    return {"local_step_ms_median": statistics.median(local),
            "sync_step_ms_median": statistics.median(sync)}


def ranks_runs(cfg, shape) -> list:
    """train_ranks' two runs in run_loops' form: the train phase's run
    with one worker a rank, per leaf and over the flat plane."""
    opt = dict(name="local_adaalter", lr=0.5, H=4, warmup_steps=100,
               compression="int8", use_kernels=True)
    return [dict(arch=cfg.name, workers=2, opt={**opt, "flat": f},
                 steps=TRAIN_STEPS, batch=shape.global_batch,
                 seq=shape.seq_len) for f in (False, True)]


def sharded_opt() -> dict:
    """train_sharded's optimizer (and sharded_grid's one-pass one)."""
    return dict(name="local_adaalter", lr=0.5, H=SHARDED_H,
                warmup_steps=100, compression="int8", use_kernels=True,
                flat=True)


def start_two_ranks(root: Path, cfg, shape) -> dict:
    """Start the one torchrun launch of two gloo ranks on the card
    (:data:`TWO_RANKS`, held for its go: :func:`start_launch`): on data
    2 x 1 train_ranks' runs (:func:`ranks_runs`) and the FSDP phases'
    (:func:`fsdp_runs`), then on 1 x 2 (TP_GRID) serve_tp and
    serve_tp_families, then train_sharded's run and train_tp's and
    train_tp_families' (:func:`tp_train_runs`,
    :func:`tp_family_train_runs`). Each phase checks its part as if it
    had launched alone."""
    data_runs = ranks_runs(cfg, shape) + fsdp_runs(cfg)["runs"]
    tp_runs = [dict(arch=cfg.name, workers=1, opt=sharded_opt(),
                    steps=SHARDED_STEPS, batch=32, seq=20)] + \
        tp_train_runs() + tp_family_train_runs()
    tmp = tempfile.TemporaryDirectory()
    serve = serve_tp_spec(str(Path(tmp.name) / "serve"))
    launch = start_launch(
        root, nproc=2, script=TWO_RANKS, spec={
            "grid": {"data": 2, "model": 1}, "runs": data_runs,
            "serve": serve, "tp_runs": tp_runs},
        what="two ranks: train_ranks, fsdp, serve_tp, train_sharded, "
             "train_tp", hold=True)
    launch.update(serve_tmp=tmp, serve_out=serve["out"])
    return launch


def two_rank_launch(launch: dict) -> dict:
    """Let :func:`start_two_ranks`' launch run and wait for it. Returns
    the parts (``runs``, ``serve`` and the prefill logits rank 0 saved,
    ``tp_runs``), the launch's wall s and the card's peak MiB."""
    import torch
    try:
        got, wall, peak_mib = finish_launch(launch, timeout=900)
        got["prefill"] = torch.load(launch["serve_out"] + ".prefill.pt")
        got["prefill_fault"] = torch.load(launch["serve_out"]
                                          + ".prefill_fault.pt")
    finally:
        launch["tmp"].cleanup()
        launch["serve_tmp"].cleanup()
    return {**got, "wall": wall, "peak_mib": peak_mib}


def train_ranks_phase(root: Path, cfg, shape, smi, leaf, flat, launched):
    """Local AdaAlter with one worker a rank: two gloo ranks on the one
    card through torchrun, at the train phase's configuration, per leaf
    and over the flat plane, each equal to the stacked run (losses,
    schedule, comm bytes, state digest) bit for bit, which a stacked run
    with η 2% off must fail; per rank the kernels' launches, collectives
    and wire bytes per round against the accounting, step walls, peak
    memory and the round's parts; the card's peak used memory under 80
    GB. Then the synchronous AdaAlter on two ranks (32 x 20 each, the
    gradients averaged) against one model over 64 x 20, float32, at lr 2
    without warm-up, 6 steps, to rtol 1e-4, which an η 2% larger must
    exceed. ``launched``: the two-rank launch (:func:`two_rank_launch`).
    Returns (report, launches by phase: rank 0's, the two-rank
    synchronous run's result, the FSDP phases' results from its launch:
    (results, wall s, card's peak MiB))."""
    import torch
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core import comm
    from repro_torch.core.flatspace import FlatSpace
    from repro_torch.core.sync_engine import make_sync_engine
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    from repro_torch.tree import leaves
    R, steps = 2, TRAIN_STEPS
    n_params = count_params(cfg)
    abstract = build_model(cfg).init(None, "meta")
    n_leaves = len(leaves(abstract))
    oc = OptimizerConfig(name="local_adaalter", lr=0.5, H=4,
                         warmup_steps=100, compression="int8",
                         use_kernels=True)
    engine = make_sync_engine(oc, H=4)
    round_b = engine.round_bytes(n_params)
    plane = FlatSpace.build(abstract, batch_ndim=0, eps=oc.eps).plane_size
    report, by_phase = {"nvidia_smi": smi, "workers": R, "backend": "gloo",
                        "runs": {}}, {}
    # both layouts in the two-rank launch (run_loops: train_loop as the
    # CLI calls it), and after them the FSDP phases' runs (fsdp_runs); the
    # synchronous baseline below goes through the CLI
    got, wall, peak_mib = (launched[k] for k in ("runs", "wall",
                                                 "peak_mib"))
    fsdp_launched = (got[2:], wall, peak_mib)
    for (name, stacked), res in zip((("per_leaf", leaf), ("flat", flat)),
                                    got):
        require(same_run(res, stacked), f"train_ranks {name}: the ranks' run "
                f"differs from the stacked one: losses {res['losses']} vs "
                f"{stacked['losses']}, digest {res['state_digest']} vs "
                f"{stacked['state_digest']}")
        rounds = len(res["sync_steps"])
        # a rank decodes every rank's row of each leaf (plane half) a
        # MEAN_CHUNK of elements at a time: one dequantize launch a chunk
        if name == "per_leaf":
            chunks = sum(-(-t.numel() // comm.MEAN_CHUNK) for t in
                         leaves(abstract))
            want_n = dict(adaalter_update=n_leaves * steps,
                          fused_ef=2 * n_leaves * rounds,
                          dequantize_blocks=2 * chunks * rounds * R)
            want_coll = engine.round_collectives(n_leaves)
        else:
            chunks = -(-plane // comm.MEAN_CHUNK)
            want_n = dict(flat_fused_update=steps, flat_ef=2 * rounds,
                          dequantize_blocks=2 * chunks * rounds * R)
            want_coll = 1
        ranks = []
        for rep in res["ranks"]:
            require_launches(rep["launches"], **want_n)
            require(rep["collectives"] == want_coll * rounds,
                    f"train_ranks {name}: {rep['collectives']} collectives "
                    f"in {rounds} rounds, want {want_coll} a round")
            per_round = rep["wire_bytes"] / rounds
            if name == "per_leaf":   # under one block's padding a leaf
                ok = 0 <= per_round - round_b < 2 * n_leaves * (256 + 4)
            else:                    # the plane's slot padding, exactly
                ok = per_round == round_b + 2 * (plane - n_params) * (
                    1 + 4 / 256)
            require(ok, f"train_ranks {name}: {per_round} wire bytes a "
                    f"round against {round_b} accounted")
            ranks.append({
                "rank": rep["rank"], "route": rep["route"],
                "launches": rep["launches"],
                "collectives_per_round": rep["collectives"] / rounds,
                "wire_bytes_per_round": per_round,
                "round_bytes_accounted": round_b,
                **rank_walls(rep, res["sync_steps"], steps),
                "step_ms": [1e3 * t for t in rep["step_s"]],
                "round_ms": {k: 1e3 * v / rounds
                             for k, v in rep["round_s"].items()},
                "max_memory_allocated_gb": rep["max_memory_allocated"] / 1e9,
                "max_memory_reserved_gb": rep["max_memory_reserved"] / 1e9})
        card_gb = peak_mib * 2**20 / 1e9
        by_rank = [(r["max_memory_allocated_gb"], r["max_memory_reserved_gb"])
                   for r in ranks]
        require(card_gb < 80.0, f"train_ranks {name}: the card used "
                f"{card_gb} GB; by rank (GB allocated, reserved): {by_rank}")
        report["runs"][name] = {
            "losses": res["losses"], "sync_steps": res["sync_steps"],
            "equal_to_stacked": True, "ranks": ranks,
            "card_memory_used_peak_gb": card_gb, "torchrun_wall_s": wall}
        by_phase["train_ranks" if name == "per_leaf"
                 else "train_ranks_flat"] = res["ranks"][0]["launches"]
    free_card()
    # the comparison must reject a stacked run with η 2% off
    off = train_loop(cfg, shape, dataclasses.replace(oc, lr=0.5 * 1.02),
                     steps=steps, n_workers=R, verbose=False, device="cuda",
                     digest=True)
    off = {"losses": off.losses, "sync_steps": off.sync_steps,
           "comm_bytes_total": off.comm_bytes_total,
           "state_digest": off.state_digest}
    require(not same_run(off, leaf), "train_ranks: a stacked run with η 2% "
            "off passes the bitwise comparison")
    report["eta_2pct_high_rejected"] = True
    free_card()

    # the synchronous baseline over two ranks against one model, float32:
    # in bf16 the halves' gradients round apart before their mean, and at
    # lr 2 the runs drift past the tolerance (4.5e-4 relative in 8 steps
    # on an H100); float32 holds the comparison to the mean's own
    # arithmetic
    base_steps = RANKS_BASELINE_STEPS
    res, wall, peak_mib = torchrun_train(root, [
        "--arch", cfg.name, "--param-dtype", "float32", "--optimizer",
        "adaalter", "--lr", "2", "--warmup", "0", "--batch",
        str(shape.global_batch), "--seq", str(shape.seq_len), "--steps",
        str(base_steps)], what="the training CLI: synchronous AdaAlter")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    one = {}
    for lr in (2.0, 2.0 * 1.02):
        one[lr] = train_loop(cfg32, shape, OptimizerConfig(
            name="adaalter", lr=lr, warmup_steps=0), steps=base_steps,
            verbose=False, device="cuda").losses
        free_card()
    rel = max_rel(res["losses"], one[2.0])
    rel_wrong = max_rel(one[2.0 * 1.02], one[2.0])
    require(rel <= 1e-4, f"train_ranks: two-rank AdaAlter off one model by "
            f"{rel} relative")
    require(rel_wrong > 1e-4, f"train_ranks: η 2% off moves the baseline's "
            f"losses by only {rel_wrong}")
    require(all(rep["wire_bytes"] == base_steps * 4 * n_params
                for rep in res["ranks"]),
            "train_ranks: the gradient mean moved other than 4 P bytes a step")
    report["baseline_adaalter"] = {
        "param_dtype": "float32", "lr": 2.0, "warmup_steps": 0,
        "steps": base_steps,
        "batch_per_rank": shape.global_batch // R,
        "losses_two_ranks": res["losses"], "losses_one_model": one[2.0],
        "max_rel_diff": rel, "max_rel_diff_eta_2pct_high": rel_wrong,
        "rtol": 1e-4,
        "grad_allreduce_bytes_per_step": res["ranks"][0]["wire_bytes"]
        / base_steps,
        "step_ms_by_rank": [[1e3 * t for t in rep["step_s"]]
                            for rep in res["ranks"]],
        "round_ms_by_rank": [{k: 1e3 * v / base_steps
                              for k, v in rep["round_s"].items()}
                             for rep in res["ranks"]],
        "max_memory_allocated_gb_by_rank": [
            rep["max_memory_allocated"] / 1e9 for rep in res["ranks"]],
        "card_memory_used_peak_gb": peak_mib * 2**20 / 1e9,
        "torchrun_wall_s": wall}
    return report, by_phase, res, fsdp_launched


def sharded_run(cfg, shape, oc, *, workers: int, shards: int, what: str,
                launched):
    """One sharded flat run as ``workers`` x ``shards`` gloo ranks on the
    card through torchrun (``launched``: the (result, wall, peak MiB) of
    the launch that ran it), against the stacked
    flat run of ``workers`` workers in this process (the same weights and
    batches): equal bit for bit (``same_run``), which the stacked run with
    η 2% off must fail. Per rank: rows 2, 4 (or 5) and 6 launched as the
    path should (the update a step, the EF encode per half a round, a
    dequantize per 2^26-element chunk of each worker-sub-group rank's row
    per half a round), one collective a round moving its sub-plane halves'
    codes and scales (``round_bytes_per_shard`` plus its share of the
    padding), one params gather a step. Returns (report, rank 0's
    launches)."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core.sync_engine import make_sync_engine
    from repro_torch.launch.train import train_loop
    from repro_torch.models.counting import count_params
    steps = SHARDED_STEPS

    def stacked(lr):
        free_card()
        r = train_loop(cfg, shape, dataclasses.replace(oc, lr=lr),
                       steps=steps, n_workers=workers, verbose=False,
                       device="cuda", digest=True)
        return {"losses": r.losses, "sync_steps": r.sync_steps,
                "comm_bytes_total": r.comm_bytes_total,
                "state_digest": r.state_digest, "step_s": r.step_s,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}
    want = stacked(oc.lr)
    off = stacked(oc.lr * 1.02)
    require(not same_run(off, want), f"{what}: a stacked run with η 2% off "
            "passes the bitwise comparison")
    free_card()
    res, wall, peak_mib = launched
    require(same_run(res, want), f"{what}: the {workers} x {shards} grid's "
            f"run differs from the stacked one: losses {res['losses']} vs "
            f"{want['losses']}, digest {res['state_digest']} vs "
            f"{want['state_digest']}")
    rounds = len(res["sync_steps"])
    require(rounds >= 1 and res["sync_steps"] == want["sync_steps"],
            f"{what}: sync steps {res['sync_steps']}")
    fs = full_plane(cfg, 1, shards=shards)
    chunks = -(-fs.shard_size // comm.MEAN_CHUNK)
    decode = 2 * chunks * rounds * workers
    if oc.sync.fused:
        want_n = dict(flat_fused_update=steps, flat_ef=2 * rounds,
                      dequantize_blocks=decode)
    else:            # the three-pass encode's own pair, a half a round
        want_n = dict(flat_fused_update=steps, quantize_blocks=2 * rounds,
                      dequantize_blocks=2 * rounds + decode)
    engine = make_sync_engine(oc, H=oc.H)
    n_params = count_params(cfg)
    shard_b = engine.round_bytes_per_shard(n_params, shards)
    ranks = []
    for rep in res["ranks"]:
        require_launches(rep["launches"], **want_n)
        per_round = rep["wire_bytes"] / rounds
        require(rep["collectives"] == rounds
                and per_round == 2 * fs.shard_size * (1 + 4 / 256),
                f"{what}: rank {rep['rank']} moved {per_round} bytes in "
                f"{rep['collectives'] / rounds} collectives a round; "
                f"accounted {shard_b} a shard")
        require(rep["shard_gathers"] == steps,
                f"{what}: rank {rep['rank']}: {rep['shard_gathers']} params "
                f"gathers in {steps} steps")
        ranks.append({
            "rank": rep["rank"], "worker": rep["worker"],
            "shard": rep["shard"], "route": rep["route"],
            "launches": rep["launches"],
            "collectives_per_round": rep["collectives"] / rounds,
            "wire_bytes_per_round": per_round,
            "round_bytes_per_shard_accounted": shard_b,
            "shard_gather_bytes_per_step": rep["shard_gather_bytes"] / steps,
            "shard_gather_ms_per_step": {
                k: 1e3 * v / steps
                for k, v in rep["shard_gather_s"].items() if v},
            **rank_walls(rep, res["sync_steps"], steps),
            "step_ms": [1e3 * t for t in rep["step_s"]],
            "round_ms": {k: 1e3 * v / rounds
                         for k, v in rep["round_s"].items()},
            "max_memory_allocated_gb": rep["max_memory_allocated"] / 1e9,
            "max_memory_reserved_gb": rep["max_memory_reserved"] / 1e9})
    card_gb = peak_mib * 2**20 / 1e9
    require(card_gb < 80.0, f"{what}: the card used {card_gb} GB")
    report = {"workers": workers, "shards": shards, "steps": steps,
              "H": oc.H, "global_batch": shape.global_batch,
              "seq": shape.seq_len, "params": n_params,
              "plane_size": fs.plane_size, "shard_size": fs.shard_size,
              "losses": res["losses"], "sync_steps": res["sync_steps"],
              "equal_to_stacked": True, "eta_2pct_high_rejected": True,
              "stacked": {"max_memory_allocated_gb":
                          want["max_memory_allocated_gb"],
                          **rank_walls(want, want["sync_steps"], steps)},
              "ranks": ranks, "card_memory_used_peak_gb": card_gb,
              "torchrun_wall_s": wall}
    return report, res["ranks"][0]["launches"]


def four_rank_loops(cfg) -> tuple:
    """sharded_grid's two runs (reduced Big LSTM, 2 x 2, one-pass and
    three-pass) and tp_grid's, first in the launch of four ranks: (the
    sharded runs' optimizers by name, the runs)."""
    ocs = {name: dict(name="local_adaalter", lr=0.5, H=SHARDED_H,
                      warmup_steps=0, compression="int8", use_kernels=True,
                      flat=True, sync_fused=fused)
           for name, fused in (("one_pass", True), ("three_pass", False))}
    return ocs, [dict(arch=cfg.name, reduced=True, workers=2, opt=opt,
                      steps=SHARDED_STEPS, batch=8, seq=16)
                 for opt in ocs.values()] + tp_grid_runs()


def grid_phases(root: Path, cfg, smi, want_logits, names,
                launched, four=None) -> dict:
    """The phases of grids with a model axis: serve_tp, serve_tp_families,
    train_sharded, train_tp and train_tp_families from the two-rank launch
    (``launched``, :func:`two_rank_launch`: on 1 x 2 after train_ranks'
    runs), and one launch of four (2 x 2) for sharded_grid's two runs and
    tp_grid's seven, which then runs slice 13's (:func:`fsdp_tp_launch`,
    :func:`fsdp_tp_phases`), each phase's checks as if it had launched
    alone; then the full-width Big LSTM TP reckoning on the meta device.
    ``names``: the kernel counters'; ``four``: the launch of four ranks
    where :func:`start_fsdp_tp_launch` started it already. Returns the
    launches by phase (rank 0's).

    ``train_sharded``: full-width Big LSTM as 1 worker x 2 shards of the
    flat plane (four ranks of a 2 x 2 grid at full width would need ~4 x
    25 GB), 32 x 20 tokens, H = 2, int8 one-pass with the kernels, 3 steps
    (one round). ``sharded_grid``: reduced Big LSTM as 2 workers x 2
    shards, where the worker sub-group's mean runs, one-pass and
    three-pass. Each equal to its stacked run bit for bit."""
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    by_phase = {}
    t0 = time.perf_counter()
    serve, reps = serve_tp_phase(launched, want_logits)
    emit({"phase": "serve_tp", "nvidia_smi": smi, **serve,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    families, by_phase["serve_tp_families"] = serve_tp_families_phase(
        reps, names)
    emit({"phase": "serve_tp_families", "nvidia_smi": smi, **families,
          "seconds": time.perf_counter() - t0})
    free_card()

    t0 = time.perf_counter()
    opt = sharded_opt()
    got, wall, peak_mib = (launched[k] for k in ("tp_runs", "wall",
                                                 "peak_mib"))
    shape = ShapeConfig("sharded", seq_len=20, global_batch=32, kind="train")
    full, by_phase["train_sharded"] = sharded_run(
        cfg, shape, OptimizerConfig(**opt), workers=1, shards=2,
        what="train_sharded", launched=(got[0], wall, peak_mib))
    emit({"phase": "train_sharded", "nvidia_smi": smi, **full,
          "seconds": time.perf_counter() - t0})
    free_card()
    t0 = time.perf_counter()
    train, by_phase["train_tp"] = train_tp_phase(got[1:3], wall, peak_mib)
    emit({"phase": "train_tp", "nvidia_smi": smi, **train,
          "seconds": time.perf_counter() - t0})
    free_card()
    t0 = time.perf_counter()
    train, by_phase["train_tp_families"] = train_tp_families_phase(
        got[3:], wall, peak_mib)
    emit({"phase": "train_tp_families", "nvidia_smi": smi, **train,
          "seconds": time.perf_counter() - t0})
    free_card()

    t0 = time.perf_counter()
    small = reduced(cfg)
    shape = ShapeConfig("grid", seq_len=16, global_batch=8, kind="train")
    grid = {}
    ocs, loops = four_rank_loops(cfg)
    # both encodes and tp_grid's models in the launch of four ranks that
    # runs slice 13's phases after them (fsdp_tp_launch)
    four = fsdp_tp_launch(root, loops, started=four)
    got, wall, peak_mib = (four[k] for k in ("loops", "wall", "peak_mib"))
    # slice 13's phases first: their lines give each run's memory a rank
    # before any check of the launch's card peak
    by_phase.update(fsdp_tp_phases(four, smi, names))
    t0 = time.perf_counter()
    for (name, opt), res in zip(ocs.items(), got):
        grid[name], launches = sharded_run(
            small, shape, OptimizerConfig(**opt), workers=2, shards=2,
            what=f"sharded_grid {name}", launched=(res, wall, peak_mib))
        by_phase["sharded_grid" if opt["sync_fused"]
                 else "sharded_grid_three_pass"] = launches
    emit({"phase": "sharded_grid", "nvidia_smi": smi, "arch": small.name,
          **grid, "seconds": time.perf_counter() - t0})
    free_card()
    t0 = time.perf_counter()
    tp_grid, by_phase["tp_grid"] = tp_grid_phase(got[2:], wall, peak_mib)
    emit({"phase": "tp_grid", "nvidia_smi": smi, **tp_grid,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "biglstm_tp_meta",
          **biglstm_tp_reckoning(get_arch("biglstm"))})
    free_card()
    return by_phase


FSDP_GRID = {"data": 2, "model": 1}
# every step of a one-model run syncs: 2 rounds
FSDP_LOCAL_STEPS = 2
# train_fsdp_moe: phi3.5-moe at full width, 1 of its 32 layers
# (1,562,980,352 parameters), synchronous AdaAlter in bf16 under its own
# plan, 8 x 512 tokens (cut from 8 x 1024 for time), 2 steps (the second
# warm)
MOE_RANKS = dict(arch="phi3.5-moe-42b-a6.6b", layers=1, dtype="bfloat16",
                 steps=2, batch=8, seq=512,
                 opt=dict(name="adaalter", lr=0.5, warmup_steps=100))


def fsdp_splits(cfg, plan, grid=FSDP_GRID):
    """Every rank's ``LeafSplit`` of each leaf of ``cfg`` under ``plan``
    (``sharding.specs``): [rank][leaf]."""
    from repro_torch.sharding import ShardingRules, leaf_split, param_shardings
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    tree = build_model(cfg).init(None, "meta")
    specs = param_shardings(ShardingRules(grid, plan), tree)
    return [[leaf_split(t.shape, sp, grid, {"data": r, "model": 0})
             for t, sp in zip(leaves(tree), specs)]
            for r in range(grid["data"])]


def fsdp_local_plan(grid=FSDP_GRID):
    """The plan resolve_plan gives phi3.5-moe (41.9 B parameters) on
    ``grid``: no worker axes, FSDP over data, remat full."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import resolve_plan
    plan = resolve_plan(get_arch("phi3.5-moe-42b-a6.6b"), grid,
                        optimizer="local_adaalter")
    require(not plan.local_axes and plan.fsdp_axes == ("data",),
            f"phi3.5-moe's plan on {grid}: {plan}")
    return plan


def moe_ranks_runs(remats=("full", "none")) -> tuple:
    """train_fsdp_moe's runs (:data:`MOE_RANKS`) for :func:`torchrun_train`,
    one a remat policy, under the plan resolve_plan gives phi3.5-moe on
    :data:`FSDP_GRID` for AdaAlter (FSDP over data, remat full): (plan,
    the cut config, runs)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import resolve_plan
    phi = get_arch(MOE_RANKS["arch"])
    plan = resolve_plan(phi, FSDP_GRID, optimizer="adaalter")
    require(plan.fsdp_axes == ("data",) and plan.remat == "full",
            f"phi3.5-moe's synchronous plan on {FSDP_GRID}: {plan}")
    cut = dataclasses.replace(phi, n_layers=MOE_RANKS["layers"],
                              param_dtype=MOE_RANKS["dtype"])
    return plan, cut, [dict(MOE_RANKS, plan=dataclasses.asdict(
        dataclasses.replace(plan, remat=r))) for r in remats]


def moe_ranks_report(results, remats=("full", "none")) -> dict:
    """Per remat policy, each rank's warm step, params gather and slice
    mean in ms, and its allocated and reserved peak GB."""
    steps = MOE_RANKS["steps"]
    return {r: {"losses": res["losses"], "ranks": [{
        "rank": rep["rank"],
        "step_ms": [1e3 * t for t in rep["step_s"]],
        "warm_step_ms": 1e3 * rep["step_s"][-1],
        "gather_ms_per_step": 1e3 * rep["round_s"]["gather"] / steps,
        "slice_mean_ms_per_step": 1e3 * sum(
            rep["round_s"][k] for k in ("d2h", "wire", "h2d", "decode_sum"))
        / steps,
        "max_memory_allocated_gb": rep["max_memory_allocated"] / 1e9,
        "max_memory_reserved_gb": rep["max_memory_reserved"] / 1e9}
        for rep in res["ranks"]]} for r, res in zip(remats, results)}


def check_fsdp_parts(gen, cfg) -> list:
    """Row 3 (the one-pass EF encode) on each distinct part shape a rank
    of train_fsdp_local encodes, unstacked (batch_ndim 0): the bf16
    params' and the fp32 B²'s, bitwise against its plain version; the
    largest part timed beside its bound."""
    import torch
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    shapes = sorted({s.part_shape for part in fsdp_splits(
        bf16, fsdp_local_plan()) for s in part}, key=math.prod,
        reverse=True)
    out = []
    for i, shape in enumerate(shapes):
        out.append(check_ef(gen, shape, torch.bfloat16, False,
                            timed=i == 0, batch_ndim=0))
        out.append(check_ef(gen, shape, torch.float32, True, timed=i == 0,
                            batch_ndim=0))
        torch.cuda.empty_cache()
    return out


def leaf_itemsizes(cfg) -> list:
    """Each parameter leaf's bytes an element (``tree.leaves`` order):
    the param dtype's, a float32 leaf's (the MoE router) 4."""
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    return [t.element_size() for t in leaves(build_model(cfg).init(
        None, "meta"))]


def split_bytes(splits, itemsizes) -> int:
    """The split leaves' bytes (``comm.fsdp_step_bytes``' split_bytes)."""
    return sum(math.prod(s.shape) * b for s, b in zip(splits, itemsizes)
               if s.split)


def fsdp_rank(rep: dict, steps: int, splits, entries: int,
              itemsizes) -> dict:
    """One FSDP rank's report: its walls, collectives and wire bytes a
    step, a step's params gather and slice mean (device to host, gloo, host
    to device, ordered sum) in ms, its state bytes beside Σ part numel ×
    (the leaf's itemsize + 4 a float32 state entry) from the specs, and its
    peak allocated and reserved GB."""
    r = rep["round_s"]
    state = sum(s.part_numel * (b + 4 * entries)
                for s, b in zip(splits, itemsizes))
    return {
        "rank": rep["rank"], "route": rep["route"],
        "step_ms": [1e3 * t for t in rep["step_s"]],
        "warm_step_ms_median": statistics.median(
            1e3 * t for t in rep["step_s"][1:]),
        "collectives_per_step": rep["collectives"] / steps,
        "wire_bytes_per_step": rep["wire_bytes"] / steps,
        "gather_ms_per_step": 1e3 * r["gather"] / steps,
        "slice_mean_ms_per_step": 1e3 * sum(
            r[k] for k in ("d2h", "wire", "h2d", "decode_sum")) / steps,
        "round_ms_per_step": {k: 1e3 * v / steps for k, v in r.items()},
        "state_bytes": rep["state_bytes"],
        "state_bytes_from_specs": state,
        "launches": rep["launches"],
        "max_memory_allocated_gb": rep["max_memory_allocated"] / 1e9,
        "max_memory_reserved_gb": rep["max_memory_reserved"] / 1e9}


def fsdp_runs(cfg) -> dict:
    """The FSDP phases' runs (run_loops' form), in train_ranks' launch of
    two ranks: the synchronous AdaAlter under the replicated plan (the
    comparison of train_ranks' CLI run, RANKS_BASELINE_STEPS steps),
    train_fsdp_local's FSDP, replicated and η 2% off runs, and
    train_fsdp_moe's (:func:`moe_ranks_runs`); with the plans they ran
    under."""
    from repro_torch.launch.mesh import resolve_plan
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    sync_plan = resolve_plan(cfg32, FSDP_GRID, optimizer="adaalter")
    require(sync_plan.fsdp_axes == ("data",),
            f"the synchronous plan {sync_plan}")
    local_plan = fsdp_local_plan()
    replicated = lambda plan: dataclasses.asdict(dataclasses.replace(
        plan, fsdp_axes=()))
    local = dict(arch=cfg.name, dtype="bfloat16", steps=FSDP_LOCAL_STEPS,
                 batch=64, seq=20, plan=dataclasses.asdict(local_plan),
                 opt=dict(name="local_adaalter", lr=0.5, H=2,
                          warmup_steps=100, compression="int8",
                          use_kernels=True))
    moe_plan, moe_cfg, moe_runs = moe_ranks_runs()
    return {"sync_plan": sync_plan, "local_plan": local_plan,
            "moe_plan": moe_plan, "moe_cfg": moe_cfg, "runs": [
                dict(arch=cfg.name, dtype="float32",
                     plan=replicated(sync_plan), steps=RANKS_BASELINE_STEPS,
                     batch=64, seq=20,
                     opt=dict(name="adaalter", lr=2.0, warmup_steps=0)),
                local, dict(local, plan=replicated(local_plan)),
                dict(local, opt=dict(local["opt"], lr=0.5 * 1.02)),
                *moe_runs]}


def fsdp_phases(cfg, smi, fsdp_cli: dict, base_steps: int, launched):
    """FSDP over the two data ranks on the card, both phases' comparison
    runs in train_ranks' torchrun launch (:func:`fsdp_runs`, ``launched``:
    their results, the launch's wall s and the card's peak MiB).
    ``train_fsdp``:
    the synchronous AdaAlter run of train_ranks (the CLI, full-width Big
    LSTM, float32, 64 x 20, lr 2), whose plan now shards every leaf over
    data, against the same run under the replicated plan (fsdp_axes=()):
    bit for bit (same_run); each rank's state bytes from the specs,
    fsdp_step_bytes (4 P) a step, its allocation under the replicated
    run's. ``train_fsdp_local``: Local AdaAlter on full-width Big LSTM in
    bf16 under phi3.5-moe's plan (one model, FSDP over data, remat full),
    int8 wire with the kernels, 2 steps, 64 x 20: bit for bit the
    replicated plan's run, which the FSDP run with η 2% off must fail; row
    3 launched 2 x 11 times a step (every step syncs) on each rank,
    nothing else. ``train_fsdp_moe``: phi3.5-moe at full width, cut to 1
    layer, synchronous AdaAlter in bf16 under its own plan (FSDP over data,
    remat full), 2 steps over 8 x 512 tokens: bit for bit the same run
    under remat none, state and wire bytes from the specs, no kernel
    launched. Returns the launches by phase (rank 0's)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import comm
    from repro_torch.models.counting import count_params
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    plans = fsdp_runs(cfg)
    sync_plan, local_plan, moe_plan, moe_cfg = (plans[k] for k in (
        "sync_plan", "local_plan", "moe_plan", "moe_cfg"))
    (want, got_l, want_l, wrong_l, *moe_res), wall, peak_mib = launched
    card_gb = peak_mib * 2**20 / 1e9
    require(card_gb < 80.0, f"fsdp phases: the card used {card_gb} GB")
    shared = {"comparison_runs_torchrun_wall_s": wall,
              "comparison_runs_card_memory_used_peak_gb": card_gb}

    n_params = count_params(cfg32)
    splits = fsdp_splits(cfg32, sync_plan)
    n_split = sum(math.prod(s.shape) for s in splits[0] if s.split)
    require(same_run(fsdp_cli, want), "train_fsdp: the FSDP run differs from "
            f"the replicated one: losses {fsdp_cli['losses']} vs "
            f"{want['losses']}, digest {fsdp_cli['state_digest']} vs "
            f"{want['state_digest']}")
    step_b = comm.fsdp_step_bytes(n_params, n_split, 2)
    require(step_b == 4 * n_params, f"fsdp_step_bytes {step_b} != 4 P")
    ranks = []
    isz = leaf_itemsizes(cfg32)
    for rep, rep_r, sp in zip(fsdp_cli["ranks"], want["ranks"], splits):
        one = fsdp_rank(rep, base_steps, sp, 1, isz)
        require(one["state_bytes"] == one["state_bytes_from_specs"]
                and rep["wire_bytes"] == base_steps * step_b,
                f"train_fsdp: rank {rep['rank']}: {one}")
        require(rep["max_memory_allocated"] < rep_r["max_memory_allocated"],
                f"train_fsdp: rank {rep['rank']} allocated "
                f"{rep['max_memory_allocated']} B, the replicated run "
                f"{rep_r['max_memory_allocated']}")
        require_launches(rep["launches"])
        one["replicated"] = fsdp_rank(rep_r, base_steps, [
            dataclasses.replace(s, dim=None, parts=1) for s in sp], 1, isz)
        ranks.append(one)
    emit({"phase": "train_fsdp", "nvidia_smi": smi, "params": n_params,
          "param_dtype": "float32", "optimizer": "adaalter", "lr": 2.0,
          "steps": base_steps, "global_batch": 64, "seq": 20,
          "plan": dataclasses.asdict(sync_plan), "split_values": n_split,
          "losses": fsdp_cli["losses"], "equal_to_replicated": True,
          "fsdp_step_bytes": step_b, "ranks": ranks, **shared})

    splits = fsdp_splits(bf16, local_plan)
    n_split = sum(math.prod(s.shape) for s in splits[0] if s.split)
    n_leaves = len(splits[0])
    steps = FSDP_LOCAL_STEPS
    require(same_run(got_l, want_l), "train_fsdp_local: the FSDP run "
            f"differs from the replicated one: losses {got_l['losses']} vs "
            f"{want_l['losses']}, digest {got_l['state_digest']} vs "
            f"{want_l['state_digest']}")
    require(not same_run(wrong_l, want_l), "train_fsdp_local: a run with η "
            "2% off passes the bitwise comparison")
    rounds = len(got_l["sync_steps"])
    require(got_l["sync_steps"] == list(range(steps)),
            f"train_fsdp_local: sync steps {got_l['sync_steps']}")
    step_b = comm.fsdp_step_bytes(count_params(bf16), n_split, 2, 2)
    ranks = []
    isz = leaf_itemsizes(bf16)
    for rep, rep_r, sp in zip(got_l["ranks"], want_l["ranks"], splits):
        require_launches(rep["launches"], fused_ef=2 * n_leaves * rounds)
        require_launches(rep_r["launches"], fused_ef=2 * n_leaves * rounds)
        one = fsdp_rank(rep, steps, sp, 4, isz)
        require(one["state_bytes"] == one["state_bytes_from_specs"]
                and rep["wire_bytes"] == steps * step_b,
                f"train_fsdp_local: rank {rep['rank']}: {one}")
        one["replicated"] = fsdp_rank(rep_r, steps, [
            dataclasses.replace(s, dim=None, parts=1) for s in sp], 4, isz)
        ranks.append(one)
    emit({"phase": "train_fsdp_local", "nvidia_smi": smi,
          "params": count_params(bf16), "param_dtype": "bfloat16",
          "plan": dataclasses.asdict(local_plan), "steps": steps, "H": 2,
          "global_batch": 64, "seq": 20, "split_values": n_split,
          "losses": got_l["losses"], "sync_steps": got_l["sync_steps"],
          "equal_to_replicated": True, "eta_2pct_high_rejected": True,
          "fsdp_step_bytes": step_b, "fused_ef_launches_per_round":
          2 * n_leaves, "ranks": ranks, **shared,
          "seconds": time.perf_counter() - t0})

    # the MoE on ranks under remat: each recomputed group routes the
    # rank's rows with the other rank's as one batch again
    full, none = moe_res
    require(same_run(full, none), "train_fsdp_moe: remat full differs from "
            f"remat none: losses {full['losses']} vs {none['losses']}, "
            f"digest {full['state_digest']} vs {none['state_digest']}")
    require(all(math.isfinite(v) for v in full["losses"]),
            f"train_fsdp_moe: losses {full['losses']}")
    splits = fsdp_splits(moe_cfg, moe_plan)
    n_split = sum(math.prod(s.shape) for s in splits[0] if s.split)
    # a bf16 model whose router is float32: the gather moves its bytes
    isz = leaf_itemsizes(moe_cfg)
    step_b = comm.fsdp_step_bytes(count_params(moe_cfg), n_split, 2,
                                  split_bytes=split_bytes(splits[0], isz))
    steps = MOE_RANKS["steps"]
    state = []
    for rep, sp in zip(full["ranks"], splits):
        require_launches(rep["launches"])
        one = fsdp_rank(rep, steps, sp, 1, isz)
        require(one["state_bytes"] == one["state_bytes_from_specs"]
                and rep["wire_bytes"] == steps * step_b,
                f"train_fsdp_moe: rank {rep['rank']}: {one}")
        state.append(one["state_bytes"])
    emit({"phase": "train_fsdp_moe", "nvidia_smi": smi,
          "arch": moe_cfg.name, "layers": moe_cfg.n_layers,
          "layers_of_config": get_arch(moe_cfg.name).n_layers,
          "params": count_params(moe_cfg), "param_dtype": moe_cfg.param_dtype,
          "plan": dataclasses.asdict(moe_plan), "steps": steps,
          "global_batch": MOE_RANKS["batch"], "seq": MOE_RANKS["seq"],
          "optimizer": MOE_RANKS["opt"], "split_values": n_split,
          "remat_full_equals_none": True, "fsdp_step_bytes": step_b,
          "state_bytes_by_rank": state, "remat": moe_ranks_report(moe_res),
          **shared})
    free_card()
    return {"train_fsdp": fsdp_cli["ranks"][0]["launches"],
            "train_fsdp_local": got_l["ranks"][0]["launches"],
            "train_fsdp_moe": full["ranks"][0]["launches"]}


def backward_peak_gb(cfg, params, batch, remat: str) -> float:
    """GB one worker's forward and backward (``loss_fn`` and its gradient,
    as a training step takes them) allocate above what is already held:
    the saved activations, the gradients and their temporaries."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, unflatten_like
    free_card()
    base = torch.cuda.memory_allocated()
    p = [t.detach().requires_grad_() for t in leaves(params)]
    loss, _ = build_model(cfg).loss_fn(unflatten_like(params, p), batch,
                                       remat=remat)
    grads = torch.autograd.grad(loss, p)
    torch.cuda.synchronize()
    del loss, grads, p
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def _port_frames(frames) -> list:
    """The frames of the port (and of this script) in an allocation's
    stack, innermost first, as ``path:line function``."""
    out = []
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name or name.endswith("chip_smoke.py"):
            short = (name.split("src/")[-1] if "repro_torch" in name
                     else "chip_smoke.py")
            out.append(f"{short}:{f['line']} {f['name']}")
    return out


def memory_peak_sites(run, top: int = 8) -> dict:
    """Run ``run()`` under the CUDA caching allocator's history (Python
    stacks) and say what set the peak of the bytes it allocated: the peak
    above what was held before, the port's frames of the allocation that
    reached it, and the blocks live at that moment grouped by the
    innermost port frame that allocated them (the autograd engine's
    device thread allocates with no Python frame). Returns also what
    ``run()`` returned."""
    import collections
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    limit = 4_000_000
    torch.cuda.memory._record_memory_history(max_entries=limit,
                                             stacks="python")
    try:
        result = run()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][torch.cuda.current_device()]
    require(len(events) < limit, "the allocator's history overflowed")
    cur = peak = 0
    at = -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] == "free_requested":
            cur -= e["size"]
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    sites = collections.Counter()
    for e in live.values():
        port = _port_frames(e.get("frames", []))
        sites[port[0] if port else "no Python frame (autograd engine)"] += (
            e["size"])
    return {"held_before_gb": base / 1e9, "peak_above_gb": peak / 1e9,
            "peak_gb": (base + peak) / 1e9, "events": len(events),
            "peak_event_frames": _port_frames(events[at].get("frames", []))
            if at >= 0 else [],
            "live_at_peak_gb_by_site": {k: v / 1e9 for k, v in
                                        sites.most_common(top)},
            "live_at_peak_gb_other_sites": sum(
                v for _, v in sites.most_common()[top:]) / 1e9}, result


def train_hybrid_remat(cfg, counters, smi, leaf, n_leaves: int):
    """``train_hybrid``'s configuration (hymba at full width,
    HYMBA_TRAIN_LAYERS of 32 layers, 2 workers x 4 x 512, H = 4, int8, rows 1 and 3 per leaf) for
    4 steps with the plan's ``remat="full"`` (each layer group recomputed
    in the backward), against the same 4 steps without: losses and the
    final state's digest bit for bit where they are, else the losses to
    rtol 1e-5 (said which); launches counted; the runs' peaks and walls,
    and one worker's forward-and-backward allocation with each policy
    ("none", "full", "dots"), which remat must lower. What sets the peaks
    (:func:`memory_peak_sites`): each policy's run again for its 3 local
    steps, whose peak remat must lower, and for 4 (a sync round at step
    3, where the run's peak is). How many of hymba's 32 layers would fit
    one card (not run), from the run's peak bytes a parameter: the sync
    round's, the same with and without remat."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                     ShapeConfig)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    R, batch, seq, steps = 2, 8, 512, 4
    shape = ShapeConfig("hybrid", seq_len=seq, global_batch=batch,
                        kind="train")
    oc = OptimizerConfig(name="local_adaalter", lr=0.5, H=4,
                         warmup_steps=100, compression="int8",
                         use_kernels=True)
    runs = {}
    for remat in ("none", "full"):
        free_card()
        for c in counters.values():
            c.reset()
        res = train_loop(cfg, shape, oc, steps=steps, n_workers=R,
                         verbose=False, device="cuda", digest=True,
                         plan=ParallelismPlan(remat=remat))
        runs[remat] = {"losses": res.losses, "sync_steps": res.sync_steps,
                       "state_digest": res.state_digest,
                       "launches": read_counts(counters),
                       **warm_stats(res, batch, seq),
                       "max_memory_allocated_gb":
                           torch.cuda.max_memory_allocated() / 1e9}
    free_card()
    plain, remat = runs["none"], runs["full"]
    require(plain["losses"] == leaf["losses"][:steps],
            "train_hybrid_remat: the 4-step run without remat left "
            "train_hybrid's losses")
    require_launches(remat["launches"], adaalter_update=n_leaves * steps,
                     fused_ef=2 * n_leaves)
    bitwise = (remat["losses"] == plain["losses"]
               and remat["state_digest"] == plain["state_digest"])
    rel = max_rel(remat["losses"], plain["losses"])
    require(bitwise or rel <= 1e-5, f"train_hybrid_remat: losses off the "
            f"run without remat by {rel} relative")
    # one worker's forward and backward on a batch of the run's shape
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    one = {k: torch.randint(0, cfg.vocab_size, (batch // R, seq),
                            generator=gen, device="cuda")
           for k in ("tokens", "labels")}
    backward = {r: backward_peak_gb(cfg, params, one, r)
                for r in ("none", "full", "dots")}
    del params
    free_card()
    require(backward["full"] < backward["none"],
            f"train_hybrid_remat: a worker's forward and backward take "
            f"{backward} GB by policy: full remat saved nothing")
    peaks = {}
    for policy in ("none", "full"):
        for n, span in ((3, "local_steps"), (4, "with_sync_round")):
            free_card()
            peaks[f"{policy}_{span}"], _ = memory_peak_sites(
                lambda: train_loop(cfg, shape, oc, steps=n, n_workers=R,
                                   verbose=False, device="cuda",
                                   plan=ParallelismPlan(remat=policy)))
            peaks[f"{policy}_{span}"]["max_memory_allocated_gb"] = (
                torch.cuda.max_memory_allocated() / 1e9)
    free_card()
    local = {p: peaks[f"{p}_local_steps"]["max_memory_allocated_gb"]
             for p in ("none", "full")}
    require(local["full"] < local["none"],
            f"train_hybrid_remat: the local steps peak at {local} GB by "
            "policy: full remat saved nothing")
    # hymba's 32 layers at the run's peak bytes a parameter
    tree = build_model(cfg).init(None, "meta")
    total = sum(t.numel() for t in leaves(tree))
    layer = sum(t.numel() for t in leaves(tree["blocks"])) // cfg.n_layers
    per_param = remat["max_memory_allocated_gb"] * 1e9 / total
    fit = int((80e9 / per_param - (total - layer * cfg.n_layers)) // layer)
    return {"nvidia_smi": smi, "arch": cfg.name, "layers": cfg.n_layers,
            "workers": R, "global_batch": batch, "seq": seq, "steps": steps,
            "remat": "full", "losses": remat["losses"],
            "losses_without": plain["losses"],
            "bitwise_equal_without": bitwise, "max_rel_diff": rel,
            "launches": remat["launches"],
            "with": {k: remat[k] for k in remat if k not in (
                "losses", "state_digest", "launches")},
            "without": {k: plain[k] for k in plain if k not in (
                "losses", "state_digest", "launches")},
            "train_hybrid_peak_gb": leaf["max_memory_allocated_gb"],
            "worker_forward_backward_gb": backward,
            "memory_peaks": peaks,
            "peak_set_by": peaks["full_with_sync_round"][
                "peak_event_frames"][:1],
            "tree_params": total, "layer_params": layer,
            "peak_bytes_per_param": per_param,
            "layers_that_fit_80gb_derived": fit}, remat["launches"]


# ---- slice 11: tensor parallelism over the model ranks ------------------ #
# train_tp: qwen2-7b at full width, 1 worker x 2 TP shards, cut to 2 of
# its 28 layers (from 4, for time; at 1 layer and lr 0.5 its losses climb
# past 20 and the TP run parts from one rank's by 2e-2, over the rtol)
TP_TRAIN_LAYERS = 2
# serve_tp: qwen2-7b cut to 2 of 28 layers (from 4, for time)
TP_SERVE_LAYERS = 2
TP_TRAIN_STEPS = 4
TP_GRID = {"data": 1, "model": 2}
# serve_tp: the TP prefill's last logits against the one-rank prefill's,
# relative L2 over the batch (bf16: the row-parallel partials are rounded
# to bf16 by their products before the float32 sum); the fault (one rank's
# wo partial dropped) must exceed it
TP_SERVE_REL_L2 = 5e-2
# serve_tp: a gloo collective takes milliseconds, ~114 a decode step, so
# its session replays 8 prompt positions (then 8 new tokens) and its
# decode fault a replay of 8 positions over an 8-slot cache split over
# the two ranks; the prefill is checked at 128 and timed at 512
TP_SERVE_REPLAY = 8
TP_FAULT_REPLAY = 8
TP_SERVE_NEW = 8
TP_CHECK_PROMPT = 128
# train_tp: TP losses against the one-rank run's (bf16; rtol), which the
# one-rank run with η 2% off must exceed (lr 0.5 without warm-up at full
# width: the losses climb, and on an H100 the runs part by 1.6e-3, η 2%
# off by 1.1e-2)
TP_TRAIN_RTOL = 4e-3
# tp_grid: lr 2 and 8 steps, as the reference phase (the η check needs the
# losses to move)
TP_GRID_STEPS = 8

# ---- slice 12: tensor parallelism for the other families ---------------- #
# serve_tp_families: label -> (arch, depth cut and dtype, options), each at
# full width on 1 x 2 gloo ranks (in serve_tp's launch), cut in depth for
# time only (the earlier cut in brackets): mamba2-370m 6 of 48
# layers (12), hymba-1.5b 2 of 32 (4), phi3.5-moe 1 of 32 (2; 8 experts a
# rank), llama-3.2-vision 5 of 40 (one cross-attention group),
# seamless-m4t 1 + 1 of 24 + 24 (2 + 2); in bf16 as configured. In bf16 the
# MoE's TP run rounds otherwise than one rank and flips near-tied routing
# choices, a token's whole output with them (on an H100: 71 of 4,096
# flipped, scoring 0.137 relative L2 off one rank), so its one-rank runs
# replay the TP run's choices ("pin": pin_routing) and the flips are
# counted; in float32 its scoring forward ("score_only") is held unpinned.
# mamba2 in float32 (its scoring forward) tells bf16 rounding over its
# layers from a fault in the head split: it must hold TP_SERVE_F32_REL_L2
TP_FAMILIES = {
    "mamba2-370m": ("mamba2-370m", {"n_layers": 6}, {}),
    "mamba2-370m/float32": ("mamba2-370m", {"n_layers": 6,
                                            "param_dtype": "float32"},
                            {"score_only": True}),
    "hymba-1.5b": ("hymba-1.5b", {"n_layers": 2}, {}),
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {"n_layers": 1},
                             {"pin": True}),
    "phi3.5-moe-42b-a6.6b/float32": (
        "phi3.5-moe-42b-a6.6b", {"n_layers": 1, "param_dtype": "float32"},
        {"score_only": True}),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {"n_layers": 5}, {}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2",
                              {"n_layers": 1, "n_encoder_layers": 1}, {})}
TP_SERVE_F32_REL_L2 = 1e-4
# a scoring forward of 1 x 2048 tokens (ssm_pallas: the SSD kernel on a
# rank's heads), a prefill at batch 8 and prompt 512, 8 decode steps from
# a seeded random cache (every leaf: the SSM state and conv tail, the KV
# ring and the cross cache) that both sides share, each rank its part
TP_FAMILY_SCORE_SEQ = 2048
TP_FAMILY_DECODE = 8
# train_tp_families: (label, arch, depth cut and dtype, remat policies,
# lr, pin): hymba-1.5b at 2 of 32 layers in bf16, lr 0.5 (remat "full"
# set: the cut falls under 1e9 parameters, where resolve_plan takes
# "none"; and "save_tp"); phi3.5-moe at 1 of 32 (its plan's "full") in
# bf16 at lr 0.2, its one-rank runs replaying the TP run's routing (pin:
# unpinned, the TP run's other rounding flips near-tied choices, 2,786 of
# 16,384 on an H100, and parts it from one rank by 2.1e-3, four times what
# η 2% off moves the pinned runs), and in float32 at lr 0.1 unpinned. 1 worker x 2 TP shards,
# Local AdaAlter int8 + kernels, 4 x 512 tokens, H = 2, 4 steps. At lr 0.5
# phi3.5-moe's losses climb (11.2 → 16.4 in float32) and part by 3.7e-2
TP_FAMILY_TRAIN = (
    ("hymba-1.5b", "hymba-1.5b", {"n_layers": 2}, ("full", "save_tp"), 0.5,
     False),
    ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b", {"n_layers": 1},
     ("full",), 0.2, True),
    ("phi3.5-moe-42b-a6.6b/float32", "phi3.5-moe-42b-a6.6b",
     {"n_layers": 1, "param_dtype": "float32"}, ("full",), 0.1, False))
# their losses against one rank's (an H100): hymba 7.8e-5 off, η 2% off
# 1.52e-3; phi3.5-moe in bf16, pinned, 3.4e-5, η 2% off 5.0e-4; in float32
# 8.6e-8, η 2% off 1.17e-3
TP_FAMILY_TRAIN_RTOL = 2e-4
# tp_grid's reduced families: 4 steps at lr 2 (from step 5 on the int8
# wire turns the row-parallel sums' other order into > 1e-4 on the CPU:
# 2.8e-4 for mamba2 at step 8), held to 3e-5, inside MODEL_RTOL: on an
# H100 they part from the stacked card and CPU runs by ≤ 4.6e-6, η 2% off
# by ≥ 9.0e-5 (mamba2)
TP_GRID_FAMILIES = ("mamba2-370m", "hymba-1.5b", "phi3.5-moe-42b-a6.6b",
                    "llama-3.2-vision-11b", "seamless-m4t-large-v2")
TP_FAMILY_GRID_STEPS = 4
TP_FAMILY_GRID_RTOL = 3e-5

# each family in turn: its weights drawn whole on both ranks (rank 0 keeps
# them for the one-rank reference), each rank its parts; the scoring
# forward with the launch counters set to 0 just before it and read just
# after; the prefill; the decode steps from a seeded random cache, whole
# on rank 0, each rank its part; the fault (rank 1 drops its out_proj
# partials, its experts' partials, or its wo partials) on the scoring
# input and on the first decode step; rank 0 holds the TP logits against
# its one-rank logits, which replay the TP run's routing where the family
# pins it
SERVE_FAMILIES = r"""
import contextlib, dataclasses, gc, math
""" + "\n".join(inspect.getsource(f) for f in (
    require, pin_routing, choice_flips)) + r"""
from repro_torch.configs import ParallelismPlan
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serving import serve_plan
from repro_torch.models import moe as moe_mod, ssm as ssm_mod
from repro_torch.models.counting import count_params
from repro_torch.sharding import ShardingRules
from repro_torch.sharding.partition import TensorParallel
gc.collect()
torch.cuda.empty_cache()

def family_cfg(arch, cut):
    c = dataclasses.replace(get_arch(arch), **cut)
    return dataclasses.replace(c, ssm_pallas=True) if c.ssm_state else c

def extras(cfg, n, frames, seed):
    g = torch.Generator(dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = torch.randn(
            (n, cfg.n_image_tokens, cfg.d_model), generator=g,
            device=dev).to(dt)
    if cfg.is_encdec:
        out["audio_frames"] = torch.randn((n, frames, cfg.d_model),
                                          generator=g, device=dev).to(dt)
    return out

@contextlib.contextmanager
def fault(cfg):
    # rank 1 drops its partials: out_proj's (SSM), its experts' (MoE),
    # wo's (the rest)
    saved = []
    if cfg.ssm_state:
        real = ssm_mod._tp_out
        def f(y, p, c, tp, by_heads):
            return real(torch.zeros_like(y) if tp.rank == 1 else y, p, c,
                        tp, by_heads)
        saved.append((ssm_mod, "_tp_out", real))
        ssm_mod._tp_out = f
    elif cfg.is_moe:
        real = moe_mod._expert_ffn
        def f(p, xin, c):
            out = real(p, xin, c)
            return torch.zeros_like(out) if group.shard == 1 else out
        saved.append((moe_mod, "_expert_ffn", real))
        moe_mod._expert_ffn = f
    else:
        real = layers.tp_linear
        rows = cfg.n_heads * cfg.head_dim // M
        def f(x, w, split, tp, **kw):
            if (split.split and split.dim == 0 and w.shape[0] == rows
                    and tp.rank == 1):
                w = torch.zeros_like(w)
            return real(x, w, split, tp, **kw)
        saved.append((layers, "tp_linear", real))
        layers.tp_linear = f
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

def timed(fn):
    comm.tp.reset()
    sync(); t0 = time.perf_counter()
    out = fn()
    sync()
    return out, {"ms": 1e3 * (time.perf_counter() - t0),
                 "tp_collectives": comm.tp.n, "tp_bytes": comm.tp.bytes,
                 "gloo_s": comm.tp.seconds["wire"]}

def routed(pin, fn, record=None, replay=None):
    # fn() with the MoE's choices recorded or replayed where the family
    # pins its routing
    if not pin:
        return fn()
    with pin_routing(record=record, replay=replay):
        return fn()

def random_cache(meta, seed):
    # every floating leaf of the whole cache drawn from one seed: each
    # rank draws the same, the one-rank run decodes from it, each rank
    # from its part
    g = torch.Generator(dev).manual_seed(seed)
    return tree_map(lambda t: torch.randn(
        t.shape, generator=g, device=dev).to(t.dtype)
        if t.dtype.is_floating_point else torch.zeros(
            t.shape, dtype=t.dtype, device=dev), meta)

res["families"] = {}
for label, (arch, cut, opts) in spec["families"].items():
    cfg = family_cfg(arch, cut)
    pin = opts.get("pin", False)
    model = build_model(cfg)
    fam = {"cut": cut, "params": count_params(cfg)}
    progs = build_serve_programs(cfg, ShapeConfig(
        "decode_32k", seq_len=P + NEW, global_batch=B, kind="decode"),
        group=group)
    full = model.init(torch.Generator(dev).manual_seed(0))
    for blk in full["blocks"]:
        if "gate" in blk:
            blk["gate"].fill_(spec["gate"])
    parts = progs.param_parts(full)
    if group.rank != 0:
        full = None
    gc.collect(); torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    items = [t.element_size() for t in leaves(model.init(None, "meta"))]
    fam["weight_bytes"] = sum(t.numel() * t.element_size()
                              for t in leaves(parts))
    fam["weight_bytes_from_specs"] = sum(
        s.part_numel * b for s, b in zip(progs.param_splits, items))
    fam["weight_bytes_whole"] = sum(math.prod(s.shape) * b for s, b in
                                    zip(progs.param_splits, items))
    grid = progs.grid
    tp = TensorParallel(group.along(("model",)), ShardingRules(
        grid, serve_plan(cfg, grid)))
    S = spec["score_seq"]
    toks = torch.randint(0, cfg.vocab_size, (1, S), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": toks, **extras(cfg, 1, S, 2)}
    with torch.inference_mode():
        model.logits_fn(parts, {**batch, "tokens": toks[:, :128]}, tp=tp)
        ssd.launches.reset()                 # the main path's run
        rec = [] if pin else None
        logits, fam["score"] = timed(lambda: routed(pin, lambda: (
            model.logits_fn(parts, batch, tp=tp)), record=rec))
        fam["score"]["ssd_launches"] = ssd.launches.n
        fam["score"]["finite"] = bool(torch.isfinite(logits).all())
        with fault(cfg):
            bad = model.logits_fn(parts, batch, tp=tp)
        if full is not None:
            want = routed(pin, lambda: model.logits_fn(full, batch),
                          replay=rec)
            fam["score"]["rel_l2_vs_one_rank"] = rel_l2(logits, want)
            fam["score"]["fault_rel_l2"] = rel_l2(bad, want)
            if pin:             # the one-rank run's own choices
                own = []
                free = routed(pin, lambda: model.logits_fn(full, batch),
                              record=own)
                fam["score"]["unpinned_rel_l2_vs_one_rank"] = rel_l2(
                    logits, free)
                fam["score"]["routing_flips"] = choice_flips(rec, own)
                fam["score"]["routing_choices"] = sum(len(r) for r in rec)
                del free
            del want
        del logits, bad
    if opts.get("score_only"):
        fam["max_memory_allocated_gb"] = (
            torch.cuda.max_memory_allocated(dev) / 1e9)
        res["families"][label] = fam
        del model, progs, full, parts, batch
        gc.collect()
        torch.cuda.empty_cache()
        continue
    whole = decode_cache_specs(cfg, ShapeConfig(
        "decode_32k", seq_len=P + NEW, global_batch=B, kind="decode"))
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), whole)
    wcache = random_cache(meta, 4)
    cache = tree_map(torch.clone, progs.cache_parts(wcache))
    if full is None:
        wcache = None
    fam["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in leaves(cache))
    fam["cache_bytes_one_rank"] = sum(t.numel() * t.element_size()
                                      for t in leaves(meta))
    fam["cache_bytes_from_specs"] = sum(
        t.numel() * t.element_size() // math.prod(
            grid[a] for e in sp if e is not None
            for a in ((e,) if isinstance(e, str) else e))
        for t, sp in zip(leaves(meta), progs.cache_specs))
    with torch.inference_mode():
        prompts = torch.from_numpy(SyntheticLM(
            vocab_size=cfg.vocab_size, seq_len=P, n_workers=1,
            seed=0).worker_batch(0, 0, B)["tokens"]).to(dev)[progs.rows]
        pb = {"tokens": prompts, **extras(cfg, B, P, 3)}
        rec = [] if pin else None
        (lg, _), fam["prefill"] = timed(lambda: routed(
            pin, lambda: progs.prefill(parts, pb), record=rec))
        fam["prefill"]["finite"] = bool(torch.isfinite(lg).all())
        if full is not None:
            want = routed(pin, lambda: model.prefill(
                full, pb, window=progs.window)[0], replay=rec)
            fam["prefill"]["rel_l2_vs_one_rank"] = rel_l2(lg, want)
        steps, errs = [], []
        for i in range(spec["decode"]):
            tok = prompts[:, i:i + 1]
            pos = torch.full((tok.shape[0],), P + i, dtype=torch.int32,
                             device=dev)
            if i == 0:          # the fault, on a copy of the cache
                with fault(cfg):
                    bad, _ = progs.decode_step(
                        parts, tree_map(torch.clone, cache), tok, pos)
            rec = [] if pin else None
            (lg, cache), st = timed(lambda: routed(
                pin, lambda: progs.decode_step(parts, cache, tok, pos),
                record=rec))
            steps.append(st)
            if full is not None:
                wl, wcache = routed(pin, lambda: model.decode_step(
                    full, wcache, tok, pos, window=progs.window),
                    replay=rec)
                errs.append(rel_l2(lg, wl))
                if i == 0:
                    fam["decode_fault_rel_l2"] = rel_l2(bad, wl)
        fam["decode"] = {
            "steps": spec["decode"],
            "ms_per_step": statistics.median(x["ms"] for x in steps),
            "tp_collectives_per_step": steps[-1]["tp_collectives"],
            "tp_bytes_per_step": steps[-1]["tp_bytes"],
            "gloo_share": statistics.median(x["gloo_s"] * 1e3 / x["ms"]
                                            for x in steps),
            "finite": bool(torch.isfinite(lg).all())}
        if errs:
            fam["decode"]["rel_l2_vs_one_rank_max"] = max(errs)
            fam["decode"]["fault_rel_l2"] = fam.pop("decode_fault_rel_l2")
    fam["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["families"][label] = fam
    del model, progs, full, parts, cache, lg, prompts, pb, batch, bad
    wcache = want = wl = None
    gc.collect()
    torch.cuda.empty_cache()
"""

# the one launch of two ranks: train_ranks' and the FSDP phases' runs on
# data 2 x 1 (RANK_LOOPS_HEAD), then the same ranks re-laid out as
# TP_GRID for serve_tp and serve_tp_families (spec["serve"]), then
# train_sharded's, train_tp's and train_tp_families' runs (spec["tp_runs"])
TWO_RANKS = RANK_LOOPS_HEAD + r"""
full_spec, t_serve = spec, time.perf_counter()
spec = full_spec["serve"]
group.split(GridLayout.of(spec["grid"]), ())
cfg = dataclasses.replace(get_arch(spec["arch"]), n_layers=spec["layers"])
B, P, NEW, REPLAY = spec["batch"], spec["prompt"], spec["new"], spec["replay"]
M = group.layout.shards
res = {"rank": group.rank}

def sync():
    torch.cuda.synchronize(dev)

def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

def programs(cache_len):
    return build_serve_programs(cfg, ShapeConfig(
        "decode_32k", seq_len=cache_len, global_batch=B, kind="decode"),
        group=group)

def zero_cache(progs, cache_len):
    whole = decode_cache_specs(cfg, ShapeConfig(
        "decode_32k", seq_len=cache_len, global_batch=B, kind="decode"))
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), whole)
    part = progs.cache_parts(meta)
    return (tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                           device=dev), part),
            sum(t.numel() * t.element_size() for t in leaves(meta)))

progs = programs(P + NEW)
params = progs.init_fn(torch.Generator(dev).manual_seed(0))
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats(dev)
itemsizes = [t.element_size() for t in leaves(build_model(cfg).init(
    None, "meta"))]
res["weight_bytes"] = sum(t.numel() * t.element_size() for t in leaves(params))
res["weight_bytes_from_specs"] = sum(
    s.part_numel * b for s, b in zip(progs.param_splits, itemsizes))
res["weight_bytes_whole"] = sum(
    __import__("math").prod(s.shape) * b
    for s, b in zip(progs.param_splits, itemsizes))
cache, whole_cache = zero_cache(progs, P + NEW)
res["cache_bytes"] = sum(t.numel() * t.element_size() for t in leaves(cache))
res["cache_bytes_one_rank"] = whole_cache
prompts = torch.from_numpy(SyntheticLM(
    vocab_size=cfg.vocab_size, seq_len=P, n_workers=1, seed=0).worker_batch(
        0, 0, B)["tokens"]).to(dev)[progs.rows]

# ---- the prefill at CHECK: against the one-rank run's, and with a fault - #
C = spec["check_prompt"]
logits, _ = progs.prefill(params, {"tokens": prompts[:, :C]})
res["prefill_finite"] = bool(torch.isfinite(logits).all())
if group.rank == 0:
    torch.save(logits.float().cpu(), spec["out"] + ".prefill.pt")
# fault: rank 1 drops its wo partial products in every layer
real_linear = layers.tp_linear
wo_rows = cfg.n_heads * cfg.head_dim // M
def drop_wo(x, w, split, tp, **kw):
    if (split.split and split.dim == 0 and w.shape[0] == wo_rows
            and tp.rank == 1):
        w = torch.zeros_like(w)
    return real_linear(x, w, split, tp, **kw)
layers.tp_linear = drop_wo
try:
    bad, _ = progs.prefill(params, {"tokens": prompts[:, :C]})
finally:
    layers.tp_linear = real_linear
if group.rank == 0:
    torch.save(bad.float().cpu(), spec["out"] + ".prefill_fault.pt")
del logits, bad

# ---- the prefill at P (warm: the prefills above ran), timed, counted ---- #
comm.tp.reset()
sync(); t0 = time.perf_counter()
logits, _ = progs.prefill(params, {"tokens": prompts})
sync()
res["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
res["prefill_tp"] = {"collectives": comm.tp.n, "bytes": comm.tp.bytes,
                     "gloo_s": comm.tp.seconds["wire"],
                     "staging_s": comm.tp.seconds["d2h"]
                     + comm.tp.seconds["h2d"]}
res["prefill_finite"] &= bool(torch.isfinite(logits).all())
del logits

# ---- decode steps at P, P + 1, ... over the zero cache ----------------- #
tok = prompts[:, -1:]
steps = []
for i in range(spec["decode_steps"]):
    pos = torch.full((tok.shape[0],), P + i, dtype=torch.int32, device=dev)
    comm.tp.reset()
    sync(); t0 = time.perf_counter()
    lg, cache = progs.decode_step(params, cache, tok, pos)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
    sync()
    steps.append({"s": time.perf_counter() - t0, "n": comm.tp.n,
                  "bytes": comm.tp.bytes, "gloo_s": comm.tp.seconds["wire"],
                  "staging_s": comm.tp.seconds["d2h"]
                  + comm.tp.seconds["h2d"]})
med = statistics.median(x["s"] for x in steps)
res["decode_ms_per_step"] = 1e3 * med
res["decode_tp_collectives_per_step"] = steps[-1]["n"]
res["decode_tp_bytes_per_step"] = steps[-1]["bytes"]
res["decode_gloo_share"] = statistics.median(x["gloo_s"] / x["s"]
                                             for x in steps)
res["decode_staging_share"] = statistics.median(x["staging_s"] / x["s"]
                                                for x in steps)
del cache

# ---- the session: prefill vs replay (SERVE_REL_L2) ---------------------- #
stats = {}
gen, tps = serve_session(cfg, batch=B, prompt_len=REPLAY, new_tokens=NEW,
                         seed=0, device=str(dev), params=params,
                         verbose=False, stats=stats, group=group)
res["session"] = {
    "prompt_len": REPLAY, "new_tokens": NEW, "tokens_per_s": tps,
    "prefill_ms": 1e3 * stats["prefill_s"],
    "decode_ms_per_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
    "logits_finite": stats["logits_finite"],
    "prefill_vs_replay_rel_l2": rel_l2(stats["prefill_logits"],
                                       stats["replay_logits"]),
    "generated": gen.tolist()}

# ---- a replay where each rank scores its slots as its neighbour's ------- #
F = spec["fault_replay"]
short = programs(F)
want = short.prefill(params, {"tokens": prompts[:, :F]})[0]
real_slots = attention._slot_positions
def neighbours(idx, positions, cache_spec):
    return real_slots((idx + idx.shape[-1]) % cache_spec.cache_len,
                      positions, cache_spec)
attention._slot_positions = neighbours
try:
    c, _ = zero_cache(short, F)
    for pos in range(F):
        lg, c = short.decode_step(params, c, prompts[:, pos:pos + 1],
                                  torch.full((prompts.shape[0],), pos,
                                             dtype=torch.int32, device=dev))
finally:
    attention._slot_positions = real_slots
res["fault_replay"] = {"positions": F, "fault_neighbour_slots_rel_l2":
                       rel_l2(lg, want)}
res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
res["max_memory_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
""" + r"""
del params, progs, short, want, lg, c, prompts
""" + SERVE_FAMILIES + r"""
everyone = [None] * group.world
dist.all_gather_object(everyone, res)
out["serve"] = everyone
if group.rank == 0:
    print(f"chip_smoke: run serve_tp and serve_tp_families "
          f"{time.perf_counter() - t_serve:.3f} s", flush=True)
out["tp_runs"] = run_loops(full_spec["tp_runs"])
""" + RANK_TAIL


def serve_tp_spec(out: str) -> dict:
    """serve_tp's and serve_tp_families' part of the two-rank launch
    (:data:`TWO_RANKS`' ``spec["serve"]``); rank 0 writes the prefill's
    logits and the fault's under ``out``."""
    return {"grid": TP_GRID, "arch": "qwen2-7b", "layers": TP_SERVE_LAYERS,
            "batch": 8, "prompt": SERVE_PROMPT, "new": TP_SERVE_NEW,
            "replay": TP_SERVE_REPLAY, "decode_steps": 4,
            "fault_replay": TP_FAULT_REPLAY,
            "check_prompt": TP_CHECK_PROMPT, "families": TP_FAMILIES,
            "gate": CROSS_GATE, "score_seq": TP_FAMILY_SCORE_SEQ,
            "decode": TP_FAMILY_DECODE, "out": out}


def serve_tp_phase(launched: dict, want_logits) -> dict:
    """Full-width qwen2-7b served on 1 x 2 gloo ranks (tensor parallelism
    over model, the KV cache's sequence split over it) through
    ``build_serve_programs(group=)`` / ``serve_session(group=)``: the
    one-rank run's weights (the same seed), each rank keeping its parts;
    a rank's weight bytes the specs' parts, its cache half the one-rank
    cache; the prefill's last logits at TP_CHECK_PROMPT against the
    one-rank prefill's (``want_logits``) to TP_SERVE_REL_L2, which rank 1
    dropping its wo partials must exceed; the session's prefill vs replay
    to SERVE_REL_L2, which a replay where each rank scores its slots as
    its neighbour's must fail; prefill ms at 512 and decode ms a step from
    position 512, the TP collectives and bytes a decode step and gloo's
    share of it. The same launch serves TP_FAMILIES after it
    (:func:`serve_tp_families_phase` reads their part of ``reps``).
    ``launched``: the two-rank launch (:func:`two_rank_launch`). Returns
    (report, the ranks' results)."""
    import torch
    from repro_torch.models.counting import count_params
    from repro_torch.configs import get_arch
    qwen = dataclasses.replace(get_arch("qwen2-7b"),
                               n_layers=TP_SERVE_LAYERS)
    reps, got, bad = (launched[k] for k in ("serve", "prefill",
                                            "prefill_fault"))
    wall, peak_mib = launched["wall"], launched["peak_mib"]
    err, fault = rel_l2(got, want_logits), rel_l2(bad, want_logits)
    require(err <= TP_SERVE_REL_L2, f"serve_tp: prefill logits off the "
            f"one-rank run's by {err} (relative L2)")
    require(fault > TP_SERVE_REL_L2, f"serve_tp: the check accepts rank 1 "
            f"dropping its wo partials ({fault})")
    for rep in reps:
        r = rep["rank"]
        require(rep["weight_bytes"] == rep["weight_bytes_from_specs"],
                f"serve_tp: rank {r} holds {rep['weight_bytes']} B of "
                f"weights, the specs {rep['weight_bytes_from_specs']}")
        require(2 * rep["cache_bytes"] == rep["cache_bytes_one_rank"],
                f"serve_tp: rank {r}'s cache {rep['cache_bytes']} B, not "
                f"half of {rep['cache_bytes_one_rank']}")
        ses = rep["session"]
        require(rep["prefill_finite"] and ses["logits_finite"],
                f"serve_tp: rank {r}: a non-finite logit")
        require(ses["prefill_vs_replay_rel_l2"] <= SERVE_REL_L2,
                f"serve_tp: rank {r}: prefill vs replay "
                f"{ses['prefill_vs_replay_rel_l2']}")
        fr = rep["fault_replay"]
        require(fr["fault_neighbour_slots_rel_l2"] > SERVE_REL_L2,
                f"serve_tp: rank {r}: the prefill/replay check accepts "
                f"ranks scoring their slots as their neighbours' ({fr})")
        require(ses["generated"] == reps[0]["session"]["generated"],
                "serve_tp: the ranks gathered different generations")
        pred = DRY["serve_tp_decode"]
        moved = {"n": rep["decode_tp_collectives_per_step"],
                 "bytes": rep["decode_tp_bytes_per_step"]}
        require(moved == pred["counters"]["tp"]
                and rep["weight_bytes"] == pred["resident"]["params"],
                f"serve_tp: rank {r}'s decode step moved {moved} over TP "
                f"and holds {rep['weight_bytes']} B of weights; the dry-run "
                f"predicted {pred}")
    gen = torch.tensor(reps[0]["session"]["generated"])
    require(gen.shape == (8, TP_SERVE_NEW) and bool(((gen >= 0)
                                           & (gen < qwen.vocab_size)).all()),
            f"serve_tp: generated tokens {tuple(gen.shape)}")
    card_gb = peak_mib * 2**20 / 1e9
    require(card_gb < 80.0, f"serve_tp: the card used {card_gb} GB")
    return ({"arch": qwen.name, "params": count_params(qwen),
             "grid": TP_GRID, "batch": 8, "prompt_len": SERVE_PROMPT,
             "new_tokens": TP_SERVE_NEW, "check_prompt": TP_CHECK_PROMPT,
             "prefill_rel_l2_vs_one_rank": err,
             "tol": TP_SERVE_REL_L2,
             "fault_wo_partial_dropped_rel_l2": fault,
             "ranks": [{**{k: v for k, v in rep.items()
                           if k != "families"},
                        "session": {k: v for k, v in rep["session"].items()
                                    if k != "generated"}}
                       for rep in reps],
             "card_memory_used_peak_gb": card_gb,
             "torchrun_wall_s": wall}, reps)


def tp_train_cfg():
    import dataclasses as dc
    from repro_torch.configs import get_arch
    return dc.replace(get_arch("qwen2-7b"), n_layers=TP_TRAIN_LAYERS)


def tp_splits(cfg, grid=TP_GRID):
    """A rank's LeafSplits of ``cfg``'s leaves under the paper-style plan
    on ``grid`` (the worker axis left out), rank by rank along model."""
    from repro_torch.configs import ParallelismPlan
    from repro_torch.models import build_model
    from repro_torch.sharding import (ShardingRules, leaf_split,
                                      param_shardings)
    from repro_torch.tree import leaves
    body = build_model(cfg).init(None, "meta")
    specs = param_shardings(ShardingRules(grid, ParallelismPlan(
        local_axes=("data",))), body)
    return [[leaf_split(t.shape, sp, grid, {"data": 0, "model": m})
             for t, sp in zip(leaves(body), specs)]
            for m in range(grid["model"])]


def check_tp_parts(gen, cfg) -> dict:
    """Rows 1 and 3 on each distinct part shape a TP rank of ``cfg``
    updates and encodes (stacked, a worker axis of 1): the params' update
    and EF encode in ``cfg``'s dtype, the fp32 B²'s encode, bitwise (row
    3) or to the update's tolerance (row 1) against their plain versions;
    the largest part timed beside its bound. Row 6 on the largest part's
    codes, decoded a 2^26-element chunk at a time."""
    import torch
    dtype = getattr(torch, cfg.param_dtype)
    part = tp_splits(cfg)[0]
    shapes = sorted({(1,) + s.part_shape for s in part}, key=math.prod,
                    reverse=True)
    upd, ef = [], []
    for i, shape in enumerate(shapes):
        upd.append(check_update(gen, shape, dtype, timed=i == 0))
        ef.append(check_ef(gen, shape, dtype, False, timed=i == 0))
        ef.append(check_ef(gen, shape, torch.float32, True, timed=i == 0))
        torch.cuda.empty_cache()
    codes = check_subplane_codes(gen, math.prod(shapes[0]))
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "shapes": [list(s) for s in shapes], "update": upd, "ef": ef,
            "codes": codes}


TP_TRAIN_OPT = dict(name="local_adaalter", lr=0.5, H=2, warmup_steps=0,
                    compression="int8", use_kernels=True)


def tp_train_runs() -> list:
    """train_tp's runs (run_loops) on TP_GRID: remat "full" (the plan's),
    then "save_tp"."""
    return [dict(arch="qwen2-7b", layers=TP_TRAIN_LAYERS, workers=1,
                 opt=TP_TRAIN_OPT, steps=TP_TRAIN_STEPS, batch=4, seq=512,
                 plan=dict(local_axes=["data"], remat=remat))
            for remat in ("full", "save_tp")]


def train_tp_phase(got, wall: float, peak_mib: int) -> tuple:
    """qwen2-7b at full width cut to TP_TRAIN_LAYERS of 28 layers, Local
    AdaAlter, int8
    wire with the kernels, as 1 worker x 2 TP shards (two gloo ranks on
    the card), 4 x 512 tokens, H = 2, 4 steps: ``got``, the results of
    :func:`tp_train_runs` (remat "full", then "save_tp"), against the
    one-rank run of the same (TP_TRAIN_RTOL, which η 2% off must exceed).
    "save_tp" equals "full" bit for bit with fewer TP collectives a step;
    a rank's state bytes equal the specs' parts. Returns (report, rank
    0's launches)."""
    import torch
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.models.counting import count_params
    cfg = tp_train_cfg()
    n_params = count_params(cfg)
    opt = TP_TRAIN_OPT
    shape = ShapeConfig("tp", seq_len=512, global_batch=4, kind="train")

    def one_rank(lr):
        free_card()
        r = train_loop(cfg, shape, OptimizerConfig(**{**opt, "lr": lr}),
                       steps=TP_TRAIN_STEPS, n_workers=1, verbose=False,
                       device="cuda")
        return {"losses": r.losses, "sync_steps": r.sync_steps,
                "step_s": r.step_s, "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}
    want, off = one_rank(opt["lr"]), one_rank(opt["lr"] * 1.02)
    free_card()
    full, save = got
    err = max_rel(full["losses"], want["losses"])
    off_err = max_rel(off["losses"], want["losses"])
    require(err <= TP_TRAIN_RTOL, f"train_tp: losses {full['losses']} off "
            f"the one-rank run's {want['losses']} by {err}")
    require(off_err > TP_TRAIN_RTOL, f"train_tp: η 2% off passes ({off_err})")
    require(full["sync_steps"] == want["sync_steps"] == [1, 3],
            f"train_tp: sync steps {full['sync_steps']}")
    require(same_run(save, full), "train_tp: save_tp differs from full")
    splits = tp_splits(cfg)
    ranks = []
    for rf, rs in zip(full["ranks"], save["ranks"]):
        part = splits[rf["shard"]]
        state = sum(s.part_numel * (2 + 4 * 4) for s in part)
        require(rf["state_bytes"] == state,
                f"train_tp: rank {rf['rank']} holds {rf['state_bytes']} B, "
                f"the specs {state}")
        require(rs["tp_collectives"] < rf["tp_collectives"],
                f"train_tp: save_tp issued {rs['tp_collectives']} TP "
                f"collectives, full {rf['tp_collectives']}")
        require(rf["launches"]["adaalter_update"] > 0
                and rf["launches"]["fused_ef"] > 0
                and rf["launches"]["dequantize_blocks"] > 0,
                f"train_tp: rank {rf['rank']} launches {rf['launches']}")
        ranks.append({
            "rank": rf["rank"], "shard": rf["shard"], "route": rf["route"],
            "state_bytes": rf["state_bytes"], "state_bytes_from_specs": state,
            "launches": rf["launches"],
            **{f"{tag}_{k}": v for tag, rep in (("full", rf), ("save_tp", rs))
               for k, v in {
                   "step_ms": [1e3 * t for t in rep["step_s"]],
                   "tp_collectives_per_step": rep["tp_collectives"]
                   / TP_TRAIN_STEPS,
                   "tp_bytes_per_step": rep["tp_bytes"] / TP_TRAIN_STEPS,
                   "tp_gloo_s_per_step": rep["tp_s"]["wire"]
                   / TP_TRAIN_STEPS,
                   "max_memory_allocated_gb":
                       rep["max_memory_allocated"] / 1e9}.items()}})
    card_gb = peak_mib * 2**20 / 1e9
    require(card_gb < 80.0, f"train_tp: the card used {card_gb} GB")
    return ({"arch": cfg.name, "layers": TP_TRAIN_LAYERS, "params": n_params,
             "grid": TP_GRID, "steps": TP_TRAIN_STEPS, "H": 2,
             "tokens_per_step": 4 * 512, "losses": full["losses"],
             "one_rank_losses": want["losses"], "rel_err": err,
             "tol": TP_TRAIN_RTOL, "eta_2pct_high_rel_err": off_err,
             "save_tp_equals_full": True, "ranks": ranks,
             "one_rank": {"step_ms": [1e3 * t for t in want["step_s"]],
                          "max_memory_allocated_gb":
                              want["max_memory_allocated_gb"]},
             "card_memory_used_peak_gb": card_gb, "torchrun_wall_s": wall},
            full["ranks"][0]["launches"])


def family_cfg(arch: str, cut: dict, *, pallas: bool = True):
    """``arch`` at full width with its depth ``cut``; the SSM families
    with ``ssm_pallas`` where ``pallas`` (serve_tp_families' ranks build
    the same; training has no SSD kernel: it has no backward)."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), **cut)
    return (dataclasses.replace(cfg, ssm_pallas=True)
            if cfg.ssm_state and pallas else cfg)


def serve_tp_families_phase(reps, names) -> tuple:
    """TP_FAMILIES served on serve_tp's 1 x 2 gloo ranks (full width,
    depth cut for time): per family a rank's weight and cache bytes equal
    the specs' parts; the scoring forward of 1 x 2048 tokens through
    ``logits_fn`` (the SSD kernel on a rank's heads, 16 of mamba2's 32 and
    25 of hymba's 50, a call a layer), the prefill at batch 8 and prompt
    512 and 8 decode steps from a random cache, each against rank 0's
    one-rank run of the same weights (replaying the TP run's routing where
    the family pins it) to TP_SERVE_REL_L2 (TP_SERVE_F32_REL_L2 for mamba2
    in float32), which the fault (rank 1 dropping its out_proj partials,
    its experts' partials, or its wo partials) must exceed on the scoring
    forward and on a decode step; walls and TP collectives. Returns
    (report, rank 0's launches by counter)."""
    out, ssd_calls = {}, 0
    for label, (arch, cut, opts) in TP_FAMILIES.items():
        cfg = family_cfg(arch, cut)
        want_ssd = cfg.n_layers if cfg.ssm_state else 0
        decode = not opts.get("score_only")
        for rep in reps:
            f, r = rep["families"][label], rep["rank"]
            require(f["weight_bytes"] == f["weight_bytes_from_specs"],
                    f"serve_tp_families {label}: rank {r} holds "
                    f"{f['weight_bytes']} B of weights, the specs "
                    f"{f['weight_bytes_from_specs']}")
            require(not decode
                    or f["cache_bytes"] == f["cache_bytes_from_specs"],
                    f"serve_tp_families {label}: rank {r}'s cache "
                    f"{f.get('cache_bytes')} B, the specs "
                    f"{f.get('cache_bytes_from_specs')}")
            require(f["score"]["finite"] and (not decode or (
                f["prefill"]["finite"] and f["decode"]["finite"])),
                    f"serve_tp_families {label}: rank {r}: a non-finite "
                    "logit")
            require(f["score"]["ssd_launches"] == want_ssd,
                    f"serve_tp_families {label}: rank {r} launched the SSD "
                    f"kernel {f['score']['ssd_launches']} times, want "
                    f"{want_ssd}")
        f0 = reps[0]["families"][label]
        tol = (TP_SERVE_F32_REL_L2 if cut.get("param_dtype") == "float32"
               and cfg.ssm_state else TP_SERVE_REL_L2)
        errs = {"score": f0["score"]["rel_l2_vs_one_rank"]}
        faults = {"score": f0["score"]["fault_rel_l2"]}
        if decode:
            errs.update(prefill=f0["prefill"]["rel_l2_vs_one_rank"],
                        decode_max=f0["decode"]["rel_l2_vs_one_rank_max"])
            faults["decode"] = f0["decode"]["fault_rel_l2"]
        require(max(errs.values()) <= tol,
                f"serve_tp_families {label}: off the one-rank run {errs} "
                f"(tolerance {tol})")
        require(min(faults.values()) > tol,
                f"serve_tp_families {label}: the check accepts rank 1 "
                f"dropping its partials ({faults})")
        ssd_calls += f0["score"]["ssd_launches"]
        out[label] = {"cut": cut, "params": f0["params"], "tol": tol,
                      "routing_pinned": bool(opts.get("pin")),
                      "rel_l2_vs_one_rank": errs, "fault_rel_l2": faults,
                      "ranks": [rep["families"][label] for rep in reps]}
        if opts.get("pin"):
            out[label].update({k: f0["score"][k] for k in (
                "unpinned_rel_l2_vs_one_rank", "routing_flips",
                "routing_choices")})
    return ({"grid": TP_GRID, "score_tokens": TP_FAMILY_SCORE_SEQ,
             "batch": 8, "prompt_len": SERVE_PROMPT,
             "decode_steps": TP_FAMILY_DECODE, "families": out},
            {k: (ssd_calls if k == "ssd_scan" else 0) for k in names})


def tp_family_train_runs() -> list:
    """train_tp_families' runs (run_loops) on TP_GRID, in
    TP_FAMILY_TRAIN's order."""
    return [dict(arch=arch, layers=cut["n_layers"],
                 dtype=cut.get("param_dtype"), workers=1,
                 opt={**TP_TRAIN_OPT, "lr": lr}, steps=TP_TRAIN_STEPS,
                 batch=4, seq=512, record_routing=pin,
                 plan=dict(local_axes=["data"], remat=remat))
            for _, arch, cut, remats, lr, pin in TP_FAMILY_TRAIN
            for remat in remats]


def train_tp_families_phase(got, wall: float, peak_mib: int) -> tuple:
    """TP_FAMILY_TRAIN as 1 worker x 2 TP shards (train_tp's launch):
    ``got``, the results of :func:`tp_family_train_runs`, against the
    one-rank run of each (TP_FAMILY_TRAIN_RTOL, which η 2% off must
    exceed; where the run pins its routing both one-rank runs replay the
    TP run's choices, and an unpinned one-rank run counts the flips);
    hymba's "save_tp" equal to "full" bit for bit; a rank's state bytes
    Σ part numel × (the leaf's itemsize + 16) from the specs; rows 1 and
    3 launched once a leaf a step and twice a leaf a round (the experts'
    parts among them) and row 6 launched. Returns (report, rank 0's
    launches over the runs)."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                     ShapeConfig)
    from repro_torch.launch.train import train_loop
    from repro_torch.models.counting import count_params
    shape = ShapeConfig("tp", seq_len=512, global_batch=4, kind="train")
    report, launches, runs = {}, None, iter(got)
    for label, arch, cut, remats, lr, pin in TP_FAMILY_TRAIN:
        cfg = family_cfg(arch, cut, pallas=False)
        res = {remat: next(runs) for remat in remats}
        full = res["full"]
        tp_routing = ([torch.tensor(c) for c in full.pop("routing")]
                      if pin else None)

        def one_rank(eta, **routing):
            free_card()
            with (pin_routing(**routing) if routing
                  else contextlib.nullcontext()):
                r = train_loop(cfg, shape, OptimizerConfig(**{
                    **TP_TRAIN_OPT, "lr": eta}), steps=TP_TRAIN_STEPS,
                    n_workers=1, verbose=False, device="cuda",
                    plan=ParallelismPlan(local_axes=("data",),
                                         remat="full"))
            return {"losses": r.losses, "sync_steps": r.sync_steps,
                    "step_ms": [1e3 * t for t in r.step_s],
                    "max_memory_allocated_gb":
                        torch.cuda.max_memory_allocated() / 1e9}
        pinned = {"replay": tp_routing} if pin else {}
        want, off = one_rank(lr, **pinned), one_rank(lr * 1.02, **pinned)
        if pin:
            own = []
            free = one_rank(lr, record=own)
        free_card()
        err = max_rel(full["losses"], want["losses"])
        off_err = max_rel(off["losses"], want["losses"])
        require(err <= TP_FAMILY_TRAIN_RTOL, f"train_tp_families {label}: "
                f"losses {full['losses']} off the one-rank run's "
                f"{want['losses']} by {err}")
        require(off_err > TP_FAMILY_TRAIN_RTOL,
                f"train_tp_families {label}: η 2% off passes ({off_err})")
        require(full["sync_steps"] == want["sync_steps"] == [1, 3],
                f"train_tp_families {label}: sync steps "
                f"{full['sync_steps']}")
        if "save_tp" in res:
            require(same_run(res["save_tp"], full),
                    f"train_tp_families {label}: save_tp differs from full")
        splits, items = tp_splits(cfg), leaf_itemsizes(cfg)
        n_leaves = len(items)
        ranks = []
        for rep in full["ranks"]:
            state = sum(s.part_numel * (b + 16)
                        for s, b in zip(splits[rep["shard"]], items))
            require(rep["state_bytes"] == state,
                    f"train_tp_families {label}: rank {rep['rank']} holds "
                    f"{rep['state_bytes']} B, the specs {state}")
            n = rep["launches"]
            require(n["adaalter_update"] == n_leaves * TP_TRAIN_STEPS
                    and n["fused_ef"] == 2 * n_leaves * 2
                    and n["dequantize_blocks"] > 0,
                    f"train_tp_families {label}: rank {rep['rank']} "
                    f"launches {n} ({n_leaves} leaves)")
            ranks.append({
                "rank": rep["rank"], "shard": rep["shard"],
                "state_bytes": rep["state_bytes"],
                "state_bytes_from_specs": state, "launches": n,
                **{f"{remat}_{k}": v for remat, r in res.items()
                   for k, v in {
                       "step_ms": [1e3 * t for t in
                                   r["ranks"][rep["rank"]]["step_s"]],
                       "tp_collectives_per_step":
                           r["ranks"][rep["rank"]]["tp_collectives"]
                           / TP_TRAIN_STEPS,
                       "tp_bytes_per_step": r["ranks"][rep["rank"]][
                           "tp_bytes"] / TP_TRAIN_STEPS,
                       "tp_gloo_s_per_step": r["ranks"][rep["rank"]][
                           "tp_s"]["wire"] / TP_TRAIN_STEPS,
                       "max_memory_allocated_gb": r["ranks"][rep["rank"]][
                           "max_memory_allocated"] / 1e9}.items()}})
        first = full["ranks"][0]["launches"]
        launches = first if launches is None else {
            k: launches[k] + first[k] for k in launches}
        report[label] = {
            "cut": cut, "lr": lr, "params": count_params(cfg),
            "remat": list(remats), "losses": full["losses"],
            "one_rank_losses": want["losses"], "rel_err": err,
            "eta_2pct_high_rel_err": off_err, "routing_pinned": pin,
            **({"unpinned_one_rank_losses": free["losses"],
                "unpinned_rel_err": max_rel(full["losses"], free["losses"]),
                "routing_flips": choice_flips(tp_routing, own),
                "routing_choices": sum(len(c) for c in own)} if pin else {}),
            "save_tp_equals_full": "save_tp" in res or None,
            "leaves": n_leaves, "ranks": ranks,
            "one_rank": {k: want[k] for k in ("step_ms",
                                              "max_memory_allocated_gb")}}
    card_gb = peak_mib * 2**20 / 1e9
    require(card_gb < 80.0, f"train_tp_families: the card used {card_gb} GB")
    return ({"grid": TP_GRID, "steps": TP_TRAIN_STEPS, "H": 2,
             "tokens_per_step": 4 * 512, "tol": TP_FAMILY_TRAIN_RTOL,
             **report,
             "card_memory_used_peak_gb": card_gb,
             "torchrun_wall_s": wall}, launches)


TP_GRID_OPT = dict(name="local_adaalter", lr=2.0, H=2, warmup_steps=0,
                   compression="int8", use_kernels=True)
TP_GRID_ARCHS = ("biglstm", "qwen2-7b") + TP_GRID_FAMILIES


def tp_grid_steps(arch: str) -> int:
    return TP_FAMILY_GRID_STEPS if arch in TP_GRID_FAMILIES else TP_GRID_STEPS


def tp_grid_rtol(arch: str) -> float:
    return TP_FAMILY_GRID_RTOL if arch in TP_GRID_FAMILIES else MODEL_RTOL


def tp_grid_runs() -> list:
    """tp_grid's runs (run_loops) on a 2 x 2 grid: reduced, float32."""
    return [dict(arch=a, reduced=True, dtype="float32", workers=2,
                 opt=TP_GRID_OPT, steps=tp_grid_steps(a), batch=8, seq=16)
            for a in TP_GRID_ARCHS]


def tp_grid_phase(got, wall: float, peak_mib: int) -> tuple:
    """Reduced Big LSTM, qwen2-7b (8 steps, MODEL_RTOL) and
    TP_GRID_FAMILIES (4 steps, TP_FAMILY_GRID_RTOL) in float32 on a 2 x 2
    grid (four gloo ranks on the card), lr 2: ``got``, the results of
    :func:`tp_grid_runs`, against the stacked 2-worker card run and the
    CPU run of the same weights to the tolerance, which the CPU run with
    η 2% larger must exceed. Returns (report, rank 0's launches of the
    last run)."""
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.launch.train import train_loop
    opt = TP_GRID_OPT
    shape = ShapeConfig("tp_grid", seq_len=16, global_batch=8, kind="train")
    report = {}
    for arch, res in zip(TP_GRID_ARCHS, got):
        cfg = dataclasses.replace(reduced(get_arch(arch)),
                                  param_dtype="float32")
        # the ranks' and the stacked card run's weights (the same seed);
        # the CPU runs ran beside the examples (tp_grid_cpu)
        steps = tp_grid_steps(arch)
        card = train_loop(cfg, shape, OptimizerConfig(**opt),
                          steps=steps, n_workers=2, verbose=False,
                          device="cuda")
        cpu = SIDE["tp_grid"][arch]
        g = res["losses"]
        errs = {"card_stacked": max_rel(g, card.losses),
                "cpu": max_rel(g, cpu["lr"]),
                "cpu_eta_2pct_high": max_rel(g, cpu["eta_2pct_high"])}
        rtol = tp_grid_rtol(arch)
        require(errs["card_stacked"] <= rtol and errs["cpu"] <= rtol,
                f"tp_grid {arch}: {errs}")
        require(errs["cpu_eta_2pct_high"] > rtol,
                f"tp_grid {arch}: η 2% off passes ({errs})")
        require(res["sync_steps"] == card.sync_steps
                and res["comm_bytes_total"] == card.comm_bytes_total,
                f"tp_grid {arch}: schedule or bytes differ")
        report[arch] = {"steps": steps, "losses": res["losses"],
                        "rel_err": errs,
                        "tol": rtol, "sync_steps": res["sync_steps"],
                        "tp_collectives_per_step": [
                            rep["tp_collectives"] / steps
                            for rep in res["ranks"]],
                        "launches": res["ranks"][0]["launches"]}
    card_gb = peak_mib * 2**20 / 1e9
    return ({**report, "card_memory_used_peak_gb": card_gb,
             "torchrun_wall_s": wall}, got[-1]["ranks"][0]["launches"])


def biglstm_tp_reckoning(cfg) -> dict:
    """Full-width Big LSTM under tensor parallelism at model = 2, from the
    package's dry-run (not run): rank 0's parameter and Local AdaAlter
    state bytes (bf16 params, four float32 entries) as its programs hold
    them on the meta device under a DryGroup, equal to the specs' parts;
    the vocabulary (793,471, odd) leaves its embed, head_w and head_b
    whole."""
    from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                     ShapeConfig)
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, paths
    splits = tp_splits(cfg)[0]
    shape = ShapeConfig("t", seq_len=20, global_batch=64, kind="train")
    body = build_model(cfg).init(None, "meta")
    whole = [(("/".join(n)), s.split) for n, s in zip(paths(body), splits)]
    oc = OptimizerConfig(name="local_adaalter", compression="int8")
    plan = ParallelismPlan(local_axes=("data",))

    def state(grid):
        _, _, resident, (_, largest) = dryrun.train_walks(
            cfg, shape, oc, grid, plan, variants=())
        require(sum(resident.values()) == largest,
                f"Big LSTM at {grid}: rank 0 holds {resident}, the largest "
                f"rank {largest}")
        return sum(resident.values())
    per_rank, total = state(TP_GRID), state({"data": 1, "model": 1})
    item = [t.element_size() for t in leaves(body)]
    require(per_rank == sum(s.part_numel * (b + 16)
                            for s, b in zip(splits, item)),
            "Big LSTM's dry-run state bytes differ from the specs' parts")
    split_values = sum(math.prod(s.shape) for s in splits if s.split)
    vocab = {n: sp for n, sp in whole if n in ("embed", "head_w", "head_b")}
    require(not any(vocab.values()), f"Big LSTM's vocab leaves split: {vocab}")
    return {"arch": cfg.name, "grid": TP_GRID,
            "state_bytes_per_rank": per_rank, "state_bytes_one_rank": total,
            "split_values": split_values,
            "values": sum(math.prod(s.shape) for s in splits),
            "vocab_leaves_whole": sorted(vocab)}


# ---- slice 13: FSDP beside tensor parallelism ---------------------------- #
FSDP_TP_GRID = {"data": 2, "model": 2}
# serve_fsdp_tp: llama3-405b at full width cut to 1 of its 126 layers
# (7,390,412,800 parameters, 14.78 GB in bf16; 2 before train_pods joined
# the launch), 2 x 2 gloo ranks under serve_plan (weight_gather_serving:
# FSDP over data beside TP over model), a prefill of 4 x 512 and 2 decode
# steps from a zero cache, against the same grid's TP-only serving (the
# weights whole over data) bit for bit. A rank gathers its peer's half of
# each TP part a forward (~3.7 GB), so the decode is cut to 2 steps: the
# second reads the cache the first wrote under gathered weights
FSDP_TP_SERVE = dict(arch="llama3-405b", layers=1, batch=4, prompt=512,
                     decode=2)
# train_fsdp_tp: (label, arch, depth cut, optimizer, steps, lr, wire,
# against the data-replicated TP run) at full width in bf16, 4 x 512
# tokens: qwen2-7b at 1 of 28 layers (4 before the 600 s budget) under
# synchronous AdaAlter (Alg. 3, the paper's baseline, its plan: FSDP over
# data, remat full), 3 steps (a round in each), bit for bit against the
# data-replicated TP run (fsdp_axes=());
# phi3.5-moe at 1 of 32
# under its own plan (one-model Local AdaAlter, int8 wire with the
# kernels, H = 2: row 3 on its tiles). phi3.5-moe's data-replicated TP run
# does not fit: each of the 4 ranks would hold 14.07 GB of state (56.3 GB
# in all, on the meta device) beside its gradient, update and encode
# temporaries (train_tp_families' 1 x 2 run of the same state peaked at
# 28.90 GB a rank on an H100), so its bitwise pair runs reduced, in
# tp_grid_fsdp_tp
FSDP_TP_TRAIN = (
    ("qwen2-7b", "qwen2-7b", 1, "adaalter", 3, 0.1, "", True),
    ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b", 1, "local_adaalter",
     2, 0.5, "int8", False))
# the reduced float32 runs that extend tp_grid on the same ranks: lr 2,
# 8 steps (llama3-405b's FSDP + TP run against its one-device card and CPU
# runs to MODEL_RTOL, which η 2% off on the CPU must exceed), 3 steps for
# the bitwise pairs (seq_parallel against none for qwen2-7b and mamba2,
# remat "dots" against "none" under TP for hymba)
FSDP_TP_GRID_STEPS, FSDP_TP_PAIR_STEPS = 8, 3
FSDP_TP_FLAT_AT = 2
# gathered-weight serving at model = 1: reduced llama3-405b in float32 on
# 4 x 1 ranks (the plan's FSDP over data, no model axis), 4 rows of 12
# prompt tokens, 2 decode steps
FSDP_TP_MODEL1 = dict(arch="llama3-405b", batch=4, prompt=12, decode=2)

# one launch of 4 gloo ranks on the card: serve_fsdp_tp (the TP-only run,
# freed, then the gathered one), train_fsdp_tp's runs and tp_grid's new
# reduced runs (train_loop a run, with the card's memory freed and its
# peak reset before each), then the ranks laid out as 4 x 1 for
# gathered-weight serving at model = 1 (reduced llama3-405b, float32)
FSDP_TP_RANKS = r"""
import dataclasses, gc, json, math, os, statistics, sys, time
import torch
from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh
from repro_torch.launch.serving import build_serve_programs, serve_plan
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.sharding import GridLayout, tile_parts
from repro_torch.tree import leaves, paths, tree_map, unflatten_like
""" + WARM_IMPORTS + r"""

spec = json.load(open(sys.argv[1]))
if os.environ.get("RANK") == "0":
    print("chip_smoke: imported", flush=True)
while spec.get("go") and not os.path.exists(spec["go"]):
    time.sleep(0.05)
group, dev = mesh.init_ranks("gloo", spec.get("device"), grid=spec["grid"],
                             fsdp_axes=("data",))
cuda = dev.type == "cuda"
T0 = time.perf_counter()

def mark(what, extra=""):
    # rank 0's line as a part ends (torchrun_train's marks)
    global T0
    if group.rank == 0:
        print(f"chip_smoke: run {what} {time.perf_counter() - T0:.3f} s"
              f"{extra}", flush=True)
    T0 = time.perf_counter()

if group.rank == 0:
    print("chip_smoke: ready", flush=True)
res = {"rank": group.rank, "serve": {}, "train": [], "grid": {}}
NORMS = ("ln1", "ln2", "ln3", "final_norm", "enc_norm", "norm_attn",
         "norm_ssm")

def sync():
    if cuda:
        torch.cuda.synchronize(dev)

def free():
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

def peak_gb():
    return torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0

def seeded(i, name, t, tp):
    # this rank's TP part (``tp``, a LeafSplit over model) of leaf i, drawn
    # on its device from seed 1000 + 64 i + its model index in the leaf's
    # dtype (the whole leaf is never made): norms 1, embed and head
    # N(0, 0.02^2), matrices N(0, 1 / the whole leaf's d_in)
    leaf = name.split("/")[-1]
    if leaf in NORMS:
        return torch.ones(tp.part_shape, dtype=t.dtype, device=dev)
    g = torch.Generator(dev).manual_seed(1000 + 64 * i
                                         + (tp.index if tp.split else 0))
    w = torch.randn(tp.part_shape, generator=g, dtype=t.dtype, device=dev)
    return w.mul_(0.02 if leaf in ("embed", "lm_head")
                  else t.shape[-2] ** -0.5)

def counts(c):
    return {"n": c.n, "bytes": c.bytes, "gloo_s": c.seconds["wire"],
            "gather_s": c.seconds["gather"],
            "staging_s": c.seconds["d2h"] + c.seconds["h2d"]}

def serve_pair(cfg, plan, B, P, D, *, keep_logits=False):
    # TP-only serving (the weights whole over data), then under ``plan``
    # (gathered weights): logits and caches bit for bit
    shape = ShapeConfig("decode_32k", seq_len=P + D, global_batch=B,
                        kind="decode")
    tp_plan = dataclasses.replace(plan, fsdp_axes=(),
                                  weight_gather_serving=False)
    model = build_model(cfg)
    abstract = model.init(None, "meta")
    names = ["/".join(p) for p in paths(abstract)]
    item = [t.element_size() for t in leaves(abstract)]
    out, kept = {}, {}
    for run, pl in (("tp", tp_plan), ("gather", plan)):
        free()
        progs = build_serve_programs(cfg, shape, group, pl)
        parts = []
        for i, (n, t, s) in enumerate(zip(names, leaves(abstract),
                                          progs.param_splits)):
            tp_s, fsdp_s = tile_parts(s, group.grid)
            w = seeded(i, n, t, tp_s)
            parts.append(fsdp_s.take(w) if fsdp_s.split else w)
            del w
        params = unflatten_like(abstract, parts)
        del parts
        free()
        rows = progs.rows
        prompts = torch.from_numpy(SyntheticLM(
            vocab_size=cfg.vocab_size, seq_len=P, n_workers=1,
            seed=0).worker_batch(0, 0, B)["tokens"]).to(dev)[rows]
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"),
                        model.init_cache(B, P + D, device="meta"))
        cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device=dev),
                         progs.cache_parts(meta))
        r = {"weight_bytes": sum(t.numel() * t.element_size()
                                 for t in leaves(params)),
             "weight_bytes_from_specs": sum(
                 s.part_numel * b for s, b in zip(progs.param_splits, item)),
             "weight_bytes_whole": sum(math.prod(s.shape) * b for s, b in
                                       zip(progs.param_splits, item)),
             "weights_at_rest_gb": peak_gb()}
        for c in (comm.tp, comm.shard_gather):
            c.reset()
        sync(); t0 = time.perf_counter()
        logits, pcache = progs.prefill(params, {"tokens": prompts})
        sync()
        r["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        r["prefill_tp"], r["prefill_gather"] = (counts(comm.tp),
                                                counts(comm.shard_gather))
        got = {"prefill_logits": logits.float().cpu(),
               "prefill_cache": [t.cpu() for t in leaves(pcache)]}
        del pcache
        tok, steps = prompts[:, -1:], []
        for i in range(D):
            pos = torch.full((tok.shape[0],), P + i, dtype=torch.int32,
                             device=dev)
            for c in (comm.tp, comm.shard_gather):
                c.reset()
            sync(); t0 = time.perf_counter()
            lg, cache = progs.decode_step(params, cache, tok, pos)
            sync()
            steps.append({"ms": 1e3 * (time.perf_counter() - t0),
                          "tp": counts(comm.tp),
                          "gather": counts(comm.shard_gather)})
            got[f"decode_logits/{i}"] = lg.float().cpu()
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
        got["decode_cache"] = [t.cpu() for t in leaves(cache)]
        r["decode_steps"] = steps
        r["decode_ms_per_step"] = statistics.median(s["ms"] for s in steps)
        r["finite"] = bool(all(torch.isfinite(v).all() for k, v in
                               got.items() if "logits" in k))
        r["peak_gb"] = peak_gb()
        r["peak_reserved_gb"] = (torch.cuda.max_memory_reserved(dev) / 1e9
                                 if cuda else 0.0)
        out[run] = r
        kept[run] = got
        del params, cache, logits, lg
    a, b = kept["gather"], kept["tp"]
    out["equal"] = {k: (all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
                        if isinstance(a[k], list) else torch.equal(a[k], b[k]))
                    for k in a}
    if not all(out["equal"].values()):     # every rank holds its own
        raise RuntimeError(f"rank {group.rank}: serving with gathered "
                           f"weights differs from TP-only: {out['equal']}")
    out["rows"] = [rows.start, rows.stop]
    if keep_logits:
        out["logits"] = {k: v.tolist() for k, v in a.items()
                         if "logits" in k}
    return out

def cfg_of(run):
    # run_loops' keys: arch, reduced, layers, dtype (and seq_parallel)
    cfg = get_arch(run["arch"])
    cfg = reduced(cfg) if run.get("reduced") else cfg
    kw = {f: run[k] for k, f in (("layers", "n_layers"),
                                 ("dtype", "param_dtype"),
                                 ("seq_parallel", "seq_parallel"))
          if run.get(k) is not None}
    return dataclasses.replace(cfg, **kw)

def train(run):
    free()
    r = train_loop(cfg_of(run), ShapeConfig(
        "t", seq_len=run["seq"], global_batch=run["batch"], kind="train"),
        OptimizerConfig(**run["opt"]), steps=run["steps"], seed=0,
        verbose=False, group=group, n_workers=run.get("workers", 1),
        device=str(dev), digest=True, plan=(
            ParallelismPlan(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in run["plan"].items()})
            if run.get("plan") else None),
        checkpoint_dir=run.get("checkpoint_dir", ""))
    out = dataclasses.asdict(r)
    out["name"] = run.get("name")
    mark(f"{run.get('name') or run['arch']} {run['steps']} steps",
         f", train_loop {r.wall_s:.3f} s")
    return out

# runs of other phases that share the launch (run_loops' form), first
res["loops"] = [train(run) for run in spec.get("loops", [])]
s = spec["serve"]
if s:
    cfg = cfg_of(s)
    res["serve"] = serve_pair(cfg, serve_plan(get_arch(s["arch"]),
                                              group.grid),
                              s["batch"], s["prompt"], s["decode"])
    mark("serve_fsdp_tp")
for run in spec["train"]:
    res["train"].append(train(run))
for run in spec["grid_runs"]:
    res["grid"][run["name"]] = train(run)
m1 = spec.get("serve_model1")
if m1:
    group.split(GridLayout(group.world, 1), ("data",))
    cfg = dataclasses.replace(reduced(get_arch(m1["arch"])),
                              param_dtype="float32")
    res["serve_model1"] = serve_pair(
        cfg, serve_plan(get_arch(m1["arch"]), group.grid), m1["batch"],
        m1["prompt"], m1["decode"], keep_logits=True)
    mark("serve_model1")
if spec.get("pods"):
    # slice 15: the ranks laid out as pod grids. A sync round's
    # collectives, bytes and parts are counted apart: everything
    # comm.wire counts inside RankGroup.round_ (the sync)
    import contextlib
    import torch.distributed as dist
    ROUND = comm.CollectiveCount()
    real_round = comm.RankGroup.round_

    @contextlib.contextmanager
    def counted_round(self):
        w0 = comm.wire.snapshot()
        with real_round(self):
            yield
        w1 = comm.wire.snapshot()
        ROUND.n += w1["n"] - w0["n"]
        ROUND.bytes += w1["bytes"] - w0["bytes"]
        for k, v in w1["seconds"].items():
            ROUND.seconds[k] += v - w0["seconds"][k]
    comm.RankGroup.round_ = counted_round
    res["pods"] = {}
    for run in spec["pods"]:
        if group.grid != run["grid"]:
            group.split(GridLayout.of(run["grid"]), ("data",))
        free()
        ROUND.reset()
        start = torch.cuda.memory_allocated(dev) if cuda else 0
        out = train(dict(run, workers=run["grid"]["pod"]))
        mine = {"round": ROUND.snapshot(), "allocated_at_start": start}
        every = [None] * group.world
        dist.all_gather_object(every, mine)
        out["rank_rounds"] = every
        res["pods"][run["name"]] = out
mesh.close_ranks()
if group.rank == 0:
    json.dump(res, open(sys.argv[2], "w"))
"""


def fsdp_tp_tiles(cfg, plan, grid=FSDP_TP_GRID):
    """Every rank's split (``LeafSplit`` or ``TileSplit``) of each leaf of
    ``cfg`` under ``plan`` on ``grid``: [rank][leaf], rank r at (r // M,
    r % M)."""
    from repro_torch.models import build_model
    from repro_torch.sharding import ShardingRules, leaf_split, param_shardings
    from repro_torch.sharding.partition import rule_overrides
    from repro_torch.tree import leaves
    tree = build_model(cfg).init(None, "meta")
    specs = param_shardings(ShardingRules(grid, plan, rule_overrides(cfg)),
                            tree)
    m = grid["model"]
    return [[leaf_split(t.shape, sp, grid, {"data": r // m, "model": r % m})
             for t, sp in zip(leaves(tree), specs)]
            for r in range(grid["data"] * m)]


def fsdp_tp_train_cfgs() -> list:
    """train_fsdp_tp's (label, arch, cut config, optimizer, steps, lr,
    wire, its plan on FSDP_TP_GRID): the full config's plan (FSDP over
    data, remat full; no worker axes)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import resolve_plan
    out = []
    for label, arch, layers, opt, steps, lr, wire, _ in FSDP_TP_TRAIN:
        full = get_arch(arch)
        plan = resolve_plan(full, FSDP_TP_GRID, optimizer=opt)
        require(plan.local_axes == () and plan.fsdp_axes == ("data",)
                and plan.remat == "full", f"{arch}'s plan: {plan}")
        cut = dataclasses.replace(full, n_layers=layers,
                                  param_dtype="bfloat16")
        out.append((label, arch, cut, opt, steps, lr, wire, plan))
    return out


def fsdp_tp_reckoning() -> dict:
    """Each rank's bytes from the package's dry-run (``launch/dryrun.py``:
    the rank's programs on the meta device under a DryGroup at
    FSDP_TP_GRID), before anything runs: serve_fsdp_tp's weights at rest
    (its tiles) against TP-only serving's (its TP parts), the largest TP
    part a gather brings up (a layer group's, the embedding's, the
    head's); train_fsdp_tp's state per rank (bf16 params; B² for
    AdaAlter, four float32 entries for Local AdaAlter) under FSDP + TP and
    under the data-replicated TP run, with the four ranks' sum against
    the card."""
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.launch import dryrun
    from repro_torch.launch.serving import serve_plan
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    from repro_torch.sharding import tile_parts
    from repro_torch.tree import leaves, paths
    s = FSDP_TP_SERVE
    full = get_arch(s["arch"])
    cfg = dataclasses.replace(reduced(full) if s.get("reduced") else full,
                              n_layers=s["layers"], **(
                                  {"param_dtype": s["dtype"]}
                                  if "dtype" in s else {}))
    plan = serve_plan(full, FSDP_TP_GRID)
    require(plan.weight_gather_serving and plan.fsdp_axes == ("data",),
            f"llama3-405b's serving plan {plan}")
    shape = ShapeConfig("decode", seq_len=s["prompt"] + s["decode"],
                        global_batch=s["batch"], kind="decode")

    def weights(pl):
        return dryrun.serve_setup(cfg, shape, FSDP_TP_GRID, pl)[3]["params"]
    tree = build_model(cfg).init(None, "meta")
    item = [t.element_size() for t in leaves(tree)]
    names = ["/".join(p) for p in paths(tree)]
    tiles = fsdp_tp_tiles(cfg, plan)[0]
    tp = [tile_parts(t, FSDP_TP_GRID)[0] for t in tiles]
    by = {"embed": 0, "lm_head": 0, "a layer group": 0}
    for n, t, b in zip(names, tp, item):
        key = n if n in by else ("a layer group" if n.startswith("blocks")
                                 else None)
        if key:
            by[key] += t.part_numel * b // (
                cfg.n_layers if key == "a layer group" else 1)
    serve = {"params": count_params(cfg),
             "weight_bytes_whole": sum(math.prod(t.shape) * b
                                       for t, b in zip(tiles, item)),
             "tile_bytes_per_rank": weights(plan),
             "tp_part_bytes_per_rank": weights(dataclasses.replace(
                 plan, fsdp_axes=(), weight_gather_serving=False)),
             "gathered_tp_part_bytes": by}
    require(serve["tile_bytes_per_rank"] == sum(
        t.part_numel * b for t, b in zip(tiles, item))
        and serve["tp_part_bytes_per_rank"] == sum(
            t.part_numel * b for t, b in zip(tp, item)),
        "serve_fsdp_tp's dry-run weight bytes differ from the specs' parts")
    serve["gather_bytes_per_forward"] = (serve["tp_part_bytes_per_rank"]
                                         - serve["tile_bytes_per_rank"])
    serve["card_gb_tp_only_weights"] = 4 * serve[
        "tp_part_bytes_per_rank"] / 1e9
    train = {}
    shape = ShapeConfig("t", seq_len=512, global_batch=4, kind="train")
    for label, _, cut, opt, _steps, lr, wire, plan in fsdp_tp_train_cfgs():
        tiles = fsdp_tp_tiles(cut, plan)[0]
        oc = OptimizerConfig(**fsdp_tp_opt(opt, lr, wire))

        def state(pl):
            _, _, resident, _ = dryrun.train_walks(
                cut, shape, oc, FSDP_TP_GRID, pl, variants=())
            return sum(resident.values())
        train[label] = {
            "params": count_params(cut),
            "state_bytes_per_rank": state(plan),
            "state_bytes_per_rank_replicated": state(dataclasses.replace(
                plan, fsdp_axes=())),
            "tile_leaves": sum(type(t).__name__ == "TileSplit"
                               for t in tiles),
            "tile_leaves_whole_blocks": sum(
                type(t).__name__ == "TileSplit" and t.whole_blocks(256)
                for t in tiles),
            "leaves": len(tiles)}
        train[label]["card_gb_replicated_states"] = 4 * train[label][
            "state_bytes_per_rank_replicated"] / 1e9
    return {"grid": FSDP_TP_GRID, "serve_fsdp_tp": serve,
            "train_fsdp_tp": train}


def check_fsdp_tp_parts(gen) -> list:
    """Row 3 (the one-pass EF encode) on each distinct tile shape a rank
    of train_fsdp_tp's phi3.5-moe run encodes in place (its tiles whose
    runs hold whole 256-blocks), unstacked (batch_ndim 0): the bf16
    params' and the fp32 B²'s, bitwise against the plain version; the
    largest tile timed beside its bound."""
    import torch
    label, _, cut, *_rest, plan = fsdp_tp_train_cfgs()[1]
    shapes = sorted({t.part_shape for part in fsdp_tp_tiles(cut, plan)
                     for t in part if type(t).__name__ == "TileSplit"
                     and t.whole_blocks(256)}, key=math.prod, reverse=True)
    out = []
    for i, shape in enumerate(shapes):
        out.append(check_ef(gen, shape, torch.bfloat16, False,
                            timed=i == 0, batch_ndim=0))
        out.append(check_ef(gen, shape, torch.float32, True, timed=i == 0,
                            batch_ndim=0))
        torch.cuda.empty_cache()
    return out


def fsdp_tp_runs(flat_dir: str) -> tuple:
    """The launch's train_fsdp_tp runs (each FSDP + TP run, then, where
    it fits, its data-replicated TP run) and tp_grid's new reduced runs."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import resolve_plan
    train = []
    for (label, arch, cut, opt, steps, lr, wire, plan), entry in zip(
            fsdp_tp_train_cfgs(), FSDP_TP_TRAIN):
        run = dict(arch=arch, layers=cut.n_layers, dtype=cut.param_dtype,
                   steps=steps, batch=4, seq=512,
                   opt=fsdp_tp_opt(opt, lr, wire),
                   plan=dataclasses.asdict(plan))
        train.append(dict(run, name=f"{label}/fsdp"))
        if entry[-1]:
            train.append(dict(run, name=f"{label}/repl",
                              plan=dataclasses.asdict(dataclasses.replace(
                                  plan, fsdp_axes=()))))
    grid = [fsdp_tp_grid_run("llama3-405b/fsdp_tp", "llama3-405b",
                             FSDP_TP_GRID_STEPS)]
    # phi3.5-moe's bitwise pair, reduced: FSDP + TP against the
    # data-replicated TP run under its plan (int8, the kernels)
    phi = get_arch("phi3.5-moe-42b-a6.6b")
    pplan = resolve_plan(phi, FSDP_TP_GRID, optimizer="local_adaalter")
    for tag, pl in (("fsdp", pplan),
                    ("repl", dataclasses.replace(pplan, fsdp_axes=()))):
        grid.append(dict(name=f"phi3.5-moe-42b-a6.6b/{tag}",
                         arch=phi.name, reduced=True, dtype="float32",
                         steps=FSDP_TP_PAIR_STEPS, batch=8, seq=16,
                         plan=dataclasses.asdict(pl),
                         opt=fsdp_tp_opt("local_adaalter", 0.5, "int8")))
    for arch in ("qwen2-7b", "mamba2-370m"):
        for sp in (True, False):
            grid.append(fsdp_tp_grid_run(f"{arch}/sp_{sp}", arch,
                                         FSDP_TP_PAIR_STEPS,
                                         seq_parallel=sp))
    for remat in ("dots", "none"):
        grid.append(fsdp_tp_grid_run(f"hymba-1.5b/{remat}", "hymba-1.5b",
                                     FSDP_TP_PAIR_STEPS, remat=remat))
    grid.append(dict(name="qwen2-7b/flat_restore", arch="qwen2-7b",
                     reduced=True, dtype="float32", workers=2,
                     steps=FSDP_TP_FLAT_AT, batch=8, seq=16,
                     opt=dict(TP_GRID_OPT), checkpoint_dir=flat_dir))
    return train, grid


def fsdp_tp_opt(name: str, lr: float, wire: str) -> dict:
    """OptimizerConfig fields of a run on FSDP_TP_GRID: no warm-up, H = 2,
    the int8 wire with the kernels where ``wire``."""
    o = dict(name=name, lr=lr, H=2, warmup_steps=0)
    if wire:
        o.update(compression=wire, use_kernels=True)
    return o


def fsdp_tp_grid_run(name, arch, steps, *, remat=None, **cfg_kw) -> dict:
    """A reduced float32 run of synchronous AdaAlter at lr 2 under the
    full config's plan for it on FSDP_TP_GRID (FSDP over data, beside TP
    over model)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import resolve_plan
    plan = resolve_plan(get_arch(arch), FSDP_TP_GRID, optimizer="adaalter")
    if remat:
        plan = dataclasses.replace(plan, remat=remat)
    return dict(name=name, arch=arch, reduced=True, dtype="float32",
                steps=steps, batch=8, seq=16, plan=dataclasses.asdict(plan),
                opt=dict(name="adaalter", lr=2.0, warmup_steps=0), **cfg_kw)


def start_fsdp_tp_launch(root: Path, loops=(), *, dev: str = "cuda",
                         hold: bool = False) -> dict:
    """Start slice 13's launch of 4 gloo ranks on the card (FSDP_TP_RANKS,
    :func:`start_launch`; ``hold``: its ranks wait for the go), which
    first runs ``loops`` (other phases' runs in run_loops' form) on the
    2 x 2 grid; its TP per-leaf run restores the flat checkpoint that
    :func:`fsdp_tp_launch` writes before the go, under
    ``launch["flat_dir"]``."""
    tmp = tempfile.TemporaryDirectory()
    flat_dir = str(Path(tmp.name) / "flat")
    train_runs, grid_runs = fsdp_tp_runs(flat_dir)
    spec = {"grid": FSDP_TP_GRID, "loops": list(loops),
            "serve": FSDP_TP_SERVE, "train": train_runs,
            "grid_runs": grid_runs, "serve_model1": FSDP_TP_MODEL1,
            "pods": pod_runs()}
    if dev != "cuda":
        spec["device"] = dev
    launch = start_launch(root, nproc=4, script=FSDP_TP_RANKS, spec=spec,
                          what="four ranks: sharded_grid, tp_grid, "
                               "fsdp_tp, train_pods", hold=hold)
    launch.update(flat_tmp=tmp, flat_dir=flat_dir)
    return launch


def fsdp_tp_launch(root: Path, loops=(), *, dev: str = "cuda",
                   started=None) -> dict:
    """The reckoning on the meta device (phase ``fsdp_tp_meta``), then
    slice 13's launch of 4 gloo ranks (``started``, where
    :func:`start_fsdp_tp_launch` started it already): around it the
    stacked flat run that writes the checkpoint its TP per-leaf run
    restores, and the stacked per-leaf restore of that checkpoint. Returns
    the launch: ``loops`` (their results), ``got`` (the ranks' results),
    ``wall``, ``peak_mib``, ``leaf_restore``, ``meta``, ``t0``."""
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.launch.train import train_loop
    t0 = time.perf_counter()
    meta = fsdp_tp_reckoning()
    emit({"phase": "fsdp_tp_meta", **meta})
    small = dataclasses.replace(reduced(get_arch("qwen2-7b")),
                                param_dtype="float32")
    flat_shape = ShapeConfig("flat", seq_len=16, global_batch=8,
                             kind="train")
    launch = started or start_fsdp_tp_launch(root, loops, dev=dev)
    flat_dir = launch["flat_dir"]
    try:
        # the flat checkpoint: the stacked 2-worker flat run on the card
        # (the ranks draw the same seeded weights)
        train_loop(small, flat_shape, OptimizerConfig(**TP_GRID_OPT,
                                                      flat=True),
                   steps=FSDP_TP_FLAT_AT, n_workers=2, verbose=False,
                   device=dev, checkpoint_dir=flat_dir,
                   checkpoint_every=FSDP_TP_FLAT_AT)
        got, wall, peak_mib = finish_launch(launch, 900.0)
        # the stacked per-leaf restore of the flat checkpoint on the card
        leaf_restore = train_loop(small, flat_shape, OptimizerConfig(
            **TP_GRID_OPT), steps=FSDP_TP_FLAT_AT, n_workers=2,
            verbose=False, device=dev, checkpoint_dir=flat_dir, digest=True)
    finally:
        launch["tmp"].cleanup()
        launch["flat_tmp"].cleanup()
    return {"loops": got.pop("loops"), "got": got, "wall": wall,
            "peak_mib": peak_mib, "leaf_restore": leaf_restore,
            "meta": meta, "t0": t0}


def fsdp_tp_phases(launched: dict, smi, names, *, dev: str = "cuda") -> dict:
    """Slice 13's phases from the launch of :func:`fsdp_tp_launch`.
    ``serve_fsdp_tp``: llama3-405b, 1 of 126 layers, bf16, on 2 x 2 ranks
    under serve_plan (gathered weights): prefill 4 x 512 and
    FSDP_TP_SERVE["decode"] decode steps, logits and caches bit for bit
    the TP-only run's; a rank's weight bytes at rest against the specs'
    tiles, the gather's bytes and
    seconds a forward, prefill and decode ms, peak GB a rank.
    ``train_fsdp_tp``: qwen2-7b 1/28 under synchronous AdaAlter, bit for
    bit the data-replicated TP run, and phi3.5-moe 1/32 under its plan
    (int8, the kernels: row 3 on its tiles); a rank's state bytes from the
    specs, step walls, TP and FSDP collectives a step.
    ``tp_grid_fsdp_tp`` (tp_grid's extension): reduced, float32, 2 x 2:
    llama3-405b under synchronous AdaAlter with FSDP + TP against its
    one-device card and CPU runs (MODEL_RTOL; η 2% off on the CPU must
    exceed it), seq_parallel = none bit for bit (qwen2-7b, mamba2), remat
    "dots" = "none" under TP (hymba), phi3.5-moe's FSDP + TP = its
    data-replicated TP run, a flat checkpoint restored into a TP per-leaf
    run (its state the stacked per-leaf restore's digest), gathered-weight
    serving at model = 1 (4 x 1) bit for bit the replicated serving and
    to MODEL_RTOL of one CPU device. Returns the launches by phase (rank
    0's)."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.launch.mesh import resolve_plan
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    got, wall, peak_mib, leaf_restore, meta, t0 = (launched[k] for k in (
        "got", "wall", "peak_mib", "leaf_restore", "meta", "t0"))
    by_phase = {}
    card_gb = peak_mib * 2**20 / 1e9
    shared = {"torchrun_wall_s": wall, "card_memory_used_peak_gb": card_gb}

    # ---- serve_fsdp_tp --------------------------------------------------- #
    sv = got["serve"]
    require(all(sv["equal"].values()), "serve_fsdp_tp: the gathered-weight "
            f"serving differs from TP-only: {sv['equal']}")
    g, tp = sv["gather"], sv["tp"]
    require(g["finite"] and tp["finite"], "serve_fsdp_tp: non-finite logits")
    require(g["weight_bytes"] == g["weight_bytes_from_specs"]
            == meta["serve_fsdp_tp"]["tile_bytes_per_rank"],
            f"serve_fsdp_tp: a rank's weights {g['weight_bytes']} B, the "
            f"specs' tiles {meta['serve_fsdp_tp']['tile_bytes_per_rank']}")
    require(g["peak_gb"] < tp["peak_gb"] or dev != "cuda", "serve_fsdp_tp: "
            f"peak {g['peak_gb']} GB with gathered weights, {tp['peak_gb']} "
            "GB TP-only")
    require(g["prefill_gather"]["n"] > 0 and tp["prefill_gather"]["n"] == 0,
            "serve_fsdp_tp: the gathers")
    emit({"phase": "serve_fsdp_tp", "nvidia_smi": smi, **FSDP_TP_SERVE,
          "layers_of_config": get_arch(FSDP_TP_SERVE["arch"]).n_layers,
          "params": meta["serve_fsdp_tp"]["params"], "grid": FSDP_TP_GRID,
          "equal_to_tp_only": sv["equal"], "gathered": g, "tp_only": tp,
          **shared})
    by_phase["serve_fsdp_tp"] = dict.fromkeys(names, 0)

    # ---- train_fsdp_tp --------------------------------------------------- #
    runs = {r["name"]: r for r in got["train"]}
    report, launches = {}, dict.fromkeys(names, 0)
    for label, _, cut, opt, steps, lr, wire, plan in fsdp_tp_train_cfgs():
        a, b = runs[f"{label}/fsdp"], runs.get(f"{label}/repl")
        require(b is None or same_run(a, b), f"train_fsdp_tp {label}: FSDP + "
                f"TP differs from the data-replicated TP run: losses "
                f"{a['losses']} vs {b and b['losses']}, digest "
                f"{a['state_digest']} vs {b and b['state_digest']}")
        require(all(math.isfinite(v) for v in a["losses"]),
                f"train_fsdp_tp {label}: losses {a['losses']}")
        m = meta["train_fsdp_tp"][label]
        tiles = fsdp_tp_tiles(cut, plan)
        per = 4 if opt == "local_adaalter" else 1
        isz = leaf_itemsizes(cut)
        ranks = []
        for rep, rep_r in zip(a["ranks"], b["ranks"] if b
                              else [None] * len(a["ranks"])):
            state = sum(t.part_numel * (s + 4 * per)
                        for t, s in zip(tiles[rep["rank"]], isz))
            require(rep["state_bytes"] == state, f"train_fsdp_tp {label}: "
                    f"rank {rep['rank']} holds {rep['state_bytes']} B, the "
                    f"specs {state}")
            pred = DRY["train_fsdp_tp"].get(label)
            if pred is not None:     # every step alike: Alg. 3's
                moved = {"wire": {"n": rep["collectives"] / steps,
                                  "bytes": rep["wire_bytes"] / steps},
                         "tp": {"n": rep["tp_collectives"] / steps,
                                "bytes": rep["tp_bytes"] / steps}}
                want = {k: pred["counters"][k] for k in moved}
                require(moved == want
                        and rep["state_bytes"] == pred["state_bytes"],
                        f"train_fsdp_tp {label}: rank {rep['rank']} moved "
                        f"{moved} a step; the dry-run predicted {want}, "
                        f"state {pred['state_bytes']} B")
            if dev != "cuda":     # the plain versions launch nothing
                pass
            elif wire:            # every leaf encoded each round, on its tile
                rounds = len(a["sync_steps"])
                require_launches(rep["launches"],
                                 fused_ef=2 * m["leaves"] * rounds)
                require(rep["launches"]["fused_ef"]
                        >= m["tile_leaves_whole_blocks"],
                        f"train_fsdp_tp {label}: row 3 launches")
            else:
                require_launches(rep["launches"])
            ranks.append({
                "rank": rep["rank"], "route": rep["route"],
                "state_bytes": rep["state_bytes"],
                "state_bytes_from_specs": state,
                "state_bytes_replicated": rep_r and rep_r["state_bytes"],
                "step_ms": [1e3 * t for t in rep["step_s"]],
                "replicated_step_ms": rep_r and [1e3 * t
                                                 for t in rep_r["step_s"]],
                "tp_collectives_per_step": rep["tp_collectives"] / steps,
                "tp_bytes_per_step": rep["tp_bytes"] / steps,
                "tp_gloo_ms_per_step": 1e3 * rep["tp_s"]["wire"] / steps,
                "fsdp_collectives_per_step": rep["collectives"] / steps,
                "fsdp_wire_bytes_per_step": rep["wire_bytes"] / steps,
                "fsdp_ms_per_step": {k: 1e3 * v / steps
                                     for k, v in rep["round_s"].items()},
                "launches": rep["launches"],
                "max_memory_allocated_gb":
                    (rep["max_memory_allocated"] or 0) / 1e9,
                "max_memory_reserved_gb":
                    (rep["max_memory_reserved"] or 0) / 1e9,
                "replicated_max_memory_allocated_gb": rep_r and (
                    rep_r["max_memory_allocated"] or 0) / 1e9})
        for k, v in a["ranks"][0]["launches"].items():
            launches[k] += v
        report[label] = {"layers": cut.n_layers, "params": m["params"],
                         "optimizer": opt, "wire": wire or "fp32",
                         "steps": steps, "lr": lr, "tokens_per_step": 4 * 512,
                         "plan": dataclasses.asdict(plan),
                         "losses": a["losses"], "sync_steps": a["sync_steps"],
                         # None: no replicated run (it does not fit)
                         "equal_to_replicated": True if b else None,
                         "ranks": ranks}
    emit({"phase": "train_fsdp_tp", "nvidia_smi": smi, "grid": FSDP_TP_GRID,
          **report, **shared})
    by_phase["train_fsdp_tp"] = launches

    # ---- tp_grid's extension -------------------------------------------- #
    gr = got["grid"]
    ext = {}
    llama = dataclasses.replace(reduced(get_arch("llama3-405b")),
                                param_dtype="float32")
    shape = ShapeConfig("tp_grid", seq_len=16, global_batch=8, kind="train")
    lplan = resolve_plan(get_arch("llama3-405b"), FSDP_TP_GRID,
                         optimizer="adaalter")
    base = tree_map(lambda t: t.cpu(), build_model(llama).init(
        torch.Generator(dev).manual_seed(0)))

    def one_device(device, lr):
        return train_loop(llama, shape, OptimizerConfig(
            name="adaalter", lr=lr, warmup_steps=0),
            steps=FSDP_TP_GRID_STEPS, verbose=False, device=device,
            plan=lplan, init_params=None if device == dev else base).losses
    ranks_l = gr["llama3-405b/fsdp_tp"]["losses"]
    errs = {"card_one_device": max_rel(ranks_l, one_device(dev, 2.0)),
            "cpu": max_rel(ranks_l, one_device("cpu", 2.0)),
            "cpu_eta_2pct_high": max_rel(ranks_l, one_device("cpu",
                                                             2.0 * 1.02))}
    require(errs["card_one_device"] <= MODEL_RTOL
            and errs["cpu"] <= MODEL_RTOL, f"tp_grid llama3-405b: {errs}")
    require(errs["cpu_eta_2pct_high"] > MODEL_RTOL,
            f"tp_grid llama3-405b: η 2% off passes ({errs})")
    ext["llama3-405b_fsdp_tp"] = {"steps": FSDP_TP_GRID_STEPS,
                                  "plan": dataclasses.asdict(lplan),
                                  "losses": ranks_l, "rel_err": errs,
                                  "tol": MODEL_RTOL}
    for arch in ("qwen2-7b", "mamba2-370m"):
        a, b = gr[f"{arch}/sp_True"], gr[f"{arch}/sp_False"]
        require(same_run(a, b), f"tp_grid {arch}: seq_parallel differs from "
                f"none: {a['losses']} vs {b['losses']}")
        ext[f"{arch}_seq_parallel"] = {
            "equal_to_none": True, "losses": a["losses"],
            "tp_collectives_per_step": [
                r["tp_collectives"] / FSDP_TP_PAIR_STEPS
                for r in (a["ranks"][0], b["ranks"][0])]}
    a, b = (gr[f"phi3.5-moe-42b-a6.6b/{t}"] for t in ("fsdp", "repl"))
    require(same_run(a, b), "tp_grid phi3.5-moe: FSDP + TP differs from the "
            f"data-replicated TP run: {a['losses']} vs {b['losses']}")
    if dev == "cuda":             # row 3 on its tiles, every leaf a round
        require(a["ranks"][0]["launches"]["fused_ef"] > 0,
                f"tp_grid phi3.5-moe: launches {a['ranks'][0]['launches']}")
    ext["phi3.5-moe_fsdp_tp"] = {"equal_to_replicated": True,
                                 "losses": a["losses"],
                                 "launches": a["ranks"][0]["launches"]}
    a, b = gr["hymba-1.5b/dots"], gr["hymba-1.5b/none"]
    require(same_run(a, b), f"tp_grid hymba: remat dots differs from none: "
            f"{a['losses']} vs {b['losses']}")
    ext["hymba-1.5b_remat_dots"] = {
        "equal_to_none": True, "losses": a["losses"],
        "tp_collectives_per_step": [
            r["tp_collectives"] / FSDP_TP_PAIR_STEPS
            for r in (a["ranks"][0], b["ranks"][0])]}
    fr = gr["qwen2-7b/flat_restore"]
    require(fr["start_step"] == FSDP_TP_FLAT_AT
            and fr["state_digest"] == leaf_restore.state_digest,
            f"tp_grid: the flat checkpoint restored into the TP per-leaf run "
            f"{fr['state_digest']}, the stacked per-leaf restore "
            f"{leaf_restore.state_digest}")
    ext["flat_into_tp_per_leaf"] = {"restored_step": fr["start_step"],
                                    "state_digest": fr["state_digest"]}
    m1 = got["serve_model1"]
    require(all(m1["equal"].values()), "tp_grid: gathered-weight serving at "
            f"model = 1 differs from replicated serving: {m1['equal']}")
    ext["serve_model1"] = fsdp_tp_model1_check(m1, dev)
    emit({"phase": "tp_grid_fsdp_tp", "nvidia_smi": smi, **ext, **shared,
          "seconds": time.perf_counter() - t0})
    by_phase["tp_grid_fsdp_tp"] = gr["phi3.5-moe-42b-a6.6b/fsdp"]["ranks"][
        0]["launches"]
    # slice 15's runs, the ranks laid out as pod grids in the same launch
    line, pods_n = pods_phase(got["pods"], wall, peak_mib, smi, dev)
    emit({"phase": "train_pods", **line})
    by_phase.update(pods_n)
    # checked after the phases' lines, which give each run's peak a rank
    require(card_gb < 80.0, f"the launch of 4 ranks: the card used "
            f"{card_gb} GB")
    free_card()
    return by_phase


def fsdp_tp_model1_check(m1, dev: str = "cuda") -> dict:
    """Gathered-weight serving of reduced llama3-405b (float32) on 4 x 1
    ranks (FSDP over data, no model axis) against one CPU device: rank 0's
    rows' prefill and decode logits to MODEL_RTOL."""
    import torch
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, paths, unflatten_like
    cfg = dataclasses.replace(reduced(get_arch(FSDP_TP_MODEL1["arch"])),
                              param_dtype="float32")
    model = build_model(cfg)
    abstract = model.init(None, "meta")
    # the ranks' seeded leaves (at model = 1 a TP part is the whole leaf,
    # seed 1000 + 64 i), drawn on ``dev`` as the ranks drew them (N(0, 1)
    # on a CUDA generator differs from the CPU's) and moved to the CPU
    B, P, D = (FSDP_TP_MODEL1[k] for k in ("batch", "prompt", "decode"))
    rows = slice(*m1["rows"])
    whole = []
    for i, (n, t) in enumerate(zip(["/".join(p) for p in paths(abstract)],
                                   leaves(abstract))):
        leaf = n.split("/")[-1]
        if leaf in ("ln1", "ln2", "ln3", "final_norm"):
            whole.append(torch.ones(t.shape, dtype=t.dtype, device=dev))
            continue
        g = torch.Generator(dev).manual_seed(1000 + 64 * i)
        w = torch.randn(t.shape, generator=g, dtype=t.dtype, device=dev)
        whole.append(w.mul_(0.02 if leaf in ("embed", "lm_head")
                            else t.shape[-2] ** -0.5))
    params = unflatten_like(abstract, [w.cpu() for w in whole])
    del whole
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=P, n_workers=1,
        seed=0).worker_batch(0, 0, B)["tokens"])[rows]
    with torch.inference_mode():
        logits, _ = model.prefill(params, {"tokens": prompts})
        cache = model.init_cache(prompts.shape[0], P + D)
        want = {"prefill_logits": logits}
        tok = prompts[:, -1:]
        for i in range(D):
            pos = torch.full((tok.shape[0],), P + i, dtype=torch.int32)
            lg, cache = model.decode_step(params, cache, tok, pos)
            want[f"decode_logits/{i}"] = lg
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
    errs = {k: float((torch.tensor(m1["logits"][k]) - v).abs().max()
                     / v.abs().max()) for k, v in want.items()}
    require(max(errs.values()) <= MODEL_RTOL,
            f"tp_grid: gathered-weight serving at model = 1 vs one CPU "
            f"device: {errs}")
    return {"grid": {"data": 4, "model": 1}, "equal_to_replicated": True,
            "rel_err_vs_cpu": errs, "tol": MODEL_RTOL,
            "gathers_per_prefill": m1["gather"]["prefill_gather"]["n"],
            "weight_bytes": m1["gather"]["weight_bytes"],
            "weight_bytes_replicated": m1["tp"]["weight_bytes"]}


# ---- slice 15: workers as pods ----------------------------------------- #
POD_GRID = {"pod": 2, "data": 2, "model": 1}
POD_GRID_TP = {"pod": 2, "data": 1, "model": 2}
# the plan whose workers are the pods: phi3.5-moe's (20-100 B parameters),
# passed as plan= to the runs that train another architecture under it
POD_PLAN_ARCH = "phi3.5-moe-42b-a6.6b"
# train_pods: mamba2-370m at full width (bf16), cut to 12 of its 48 layers
# for the script's time (24 before its 600 s budget; at 48 the runs (a)
# and (b) took 52 s of gloo on an H100, the prediction 16 s), on 2 pods x
# 2 data ranks sharing the card, 8 x 512 tokens (a rank's 2 rows of its
# pod's 4), Local AdaAlter H = 2, int8 wire with the kernels, 3 steps (a
# round and a local step after it; 4 before): the pod run (a),
# its data-replicated run (b, fsdp_axes=()), and the flat twin (c) at
# POD_FLAT_LAYERS beside its per-leaf run at that depth, both in float32
# (the digests then compare the same bits: a bf16 leaf's plane slot holds
# its value in float32)
POD_RUN = dict(arch="mamba2-370m", layers=12, dtype="bfloat16", steps=3,
               batch=8, seq=512)
POD_FLAT_LAYERS = 3
POD_OPT = dict(name="local_adaalter", lr=0.5, H=2, warmup_steps=0,
               compression="int8", use_kernels=True)
# runs (d): reduced phi3.5-moe in float32 under its own plan on both pod
# grids, 4 steps, against the stacked run of 2 workers on the CPU (the
# plain versions) to MODEL_RTOL, which η 2% larger on the CPU must exceed
POD_PHI = dict(arch=POD_PLAN_ARCH, reduced=True, dtype="float32", steps=4,
               batch=8, seq=16)


def pod_plan(grid=POD_GRID):
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import resolve_plan
    plan = resolve_plan(get_arch(POD_PLAN_ARCH), grid)
    require(tuple(plan.local_axes) == ("pod",)
            and tuple(plan.fsdp_axes) == ("data",),
            f"{POD_PLAN_ARCH}'s plan on {grid}: {plan}")
    return plan


def pod_cfg(layers=None):
    import dataclasses as dc
    from repro_torch.configs import get_arch
    return dc.replace(get_arch(POD_RUN["arch"]),
                      param_dtype=POD_RUN["dtype"],
                      n_layers=layers or POD_RUN["layers"])


def pod_runs() -> list:
    """train_pods' runs in FSDP_TP_RANKS' form: (a), (b), the flat twin and
    its per-leaf run, and the reduced phi3.5-moe runs (d)."""
    plan = dataclasses.asdict(pod_plan())
    repl = dict(plan, fsdp_axes=())
    base = dict(POD_RUN, grid=POD_GRID, opt=dict(POD_OPT))
    runs = [dict(base, name="mamba2/fsdp", plan=plan),
            dict(base, name="mamba2/repl", plan=repl),
            dict(base, name="mamba2_flat/fsdp", plan=plan,
                 layers=POD_FLAT_LAYERS, dtype="float32"),
            dict(base, name="mamba2_flat/flat", plan=plan,
                 layers=POD_FLAT_LAYERS, dtype="float32",
                 opt=dict(POD_OPT, flat=True))]
    for grid in (POD_GRID, POD_GRID_TP):
        runs.append(dict(POD_PHI, name="phi/" + "x".join(
            str(v) for v in grid.values()), grid=grid,
            plan=dataclasses.asdict(pod_plan(grid)), opt=dict(POD_OPT)))
    return runs


def pod_tiles(cfg, plan=None, grid=POD_GRID):
    """Rank 0's split of each leaf of ``cfg``'s worker under the pod plan
    (its tiles over its pod's data ranks)."""
    from repro_torch.models import build_model
    from repro_torch.sharding import ShardingRules, leaf_split, param_shardings
    from repro_torch.sharding.partition import rule_overrides
    from repro_torch.tree import leaves
    plan = plan or pod_plan(grid)
    tree = build_model(cfg).init(None, "meta")
    specs = param_shardings(ShardingRules(grid, plan, rule_overrides(cfg)),
                            tree)
    coords = dict.fromkeys(grid, 0)
    return [leaf_split(t.shape, sp, grid, coords)
            for t, sp in zip(leaves(tree), specs)]


def pod_prediction() -> dict:
    """Run (a)'s rank 0 on the meta device before anything runs (the
    package's dry-run: ``launch/dryrun.py::train_walks`` under a DryGroup
    on POD_GRID, the pods as workers): its collectives, bytes and kernels
    a local step and a sync step, its state and its peak of live bytes.
    Every rank holds tiles of one shape (the splits are even), so the
    other ranks are held to rank 0's."""
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cfg, plan = pod_cfg(), pod_plan()
    shape = ShapeConfig("t", seq_len=POD_RUN["seq"],
                        global_batch=POD_RUN["batch"], kind="train")
    walks, progs, resident, spec_bytes = dryrun.train_walks(
        cfg, shape, OptimizerConfig(**POD_OPT), POD_GRID, plan)
    require(spec_bytes[0] == spec_bytes[1], "train_pods: the ranks' state "
            f"differs by rank {spec_bytes}")
    out = {"state_bytes": sum(resident.values()), "resident": resident,
           "spec_state_bytes": spec_bytes[0],
           "payload_leaves": progs.n_payload_leaves}
    for name, (cost, counters, log) in walks.items():
        out[name] = {"counters": counters, "kernels": dict(cost.kernels),
                     "peak_bytes": cost.peak_bytes,
                     "cross_pod_collectives": sum(e["cross_pod"]
                                                  for e in log),
                     "flops": cost.flops, "bytes": cost.bytes}
    out["peak_bytes"] = max(out[k]["peak_bytes"] for k in walks)
    # a round: the sync step's collectives beyond its local step's
    out["round"] = {k: out["sync_step"]["counters"]["wire"][k]
                    - out["local_step"]["counters"]["wire"][k]
                    for k in ("n", "bytes")}
    # the accounting of what a rank sends a round (params and B², one
    # collective each a leaf): its tile, or the whole leaf where the tile's
    # runs straddle a 256-block; the wire carries whole blocks (a leaf's
    # last block padded), int8 codes and an fp32 scale each
    from repro_torch.core.comm import payload_bytes
    tiles = pod_tiles(cfg, plan)
    sent = [s.part_numel if s.whole_blocks(256) else math.prod(s.shape)
            for s in tiles]
    out["round_accounting"] = {
        "n": 2 * len(tiles),
        "bytes": sum(2 * payload_bytes(n, 4, "int8") for n in sent),
        "wire_bytes_whole_blocks": sum(2 * -(-n // 256) * (256 + 4)
                                       for n in sent),
        "tile_values": sum(s.part_numel for s in tiles),
        "leaves_encoded_whole": sum(not s.whole_blocks(256) for s in tiles)}
    acc = out["round_accounting"]
    require(out["round"] == {"n": acc["n"],
                             "bytes": acc["wire_bytes_whole_blocks"]},
            f"train_pods: the walked round {out['round']} differs from the "
            f"accounting of a rank's tiles {acc}")
    out["seconds"] = time.perf_counter() - t0
    return out


def check_pod_parts(gen) -> dict:
    """Rows 1, 3 and 6 on each distinct tile shape a train_pods rank
    updates and encodes (a worker axis of 1), as check_tp_parts does; rows
    2 and 4 on each of a pod's sub-planes of the flat twin's plane (its
    D x M = 2 shards)."""
    import torch
    tiles = pod_tiles(pod_cfg())
    shapes = sorted({(1,) + s.part_shape for s in tiles if
                     s.whole_blocks(256)}, key=math.prod, reverse=True)
    upd, ef = [], []
    for i, shape in enumerate(shapes):
        upd.append(check_update(gen, shape, torch.bfloat16, timed=i == 0))
        ef.append(check_ef(gen, shape, torch.bfloat16, False, timed=i == 0))
        ef.append(check_ef(gen, shape, torch.float32, True, timed=i == 0))
        torch.cuda.empty_cache()
    codes = check_subplane_codes(gen, math.prod(shapes[0]))
    fs = full_plane(dataclasses.replace(pod_cfg(POD_FLAT_LAYERS),
                                        param_dtype="float32"), 1, shards=2)
    flat_upd = [check_flat_update(gen, fs, timed=False, shard=s)
                for s in range(fs.shards)]
    torch.cuda.empty_cache()
    flat_ef = [check_flat_ef(gen, fs, half, timed=False, shard=s)
               for s in range(fs.shards) for half in ("params", "b2")]
    torch.cuda.empty_cache()
    return {"arch": POD_RUN["arch"], "shapes": [list(s) for s in shapes],
            "update": upd, "ef": ef, "codes": codes,
            "flat_update": flat_upd, "flat_ef": flat_ef}


def pods_phase(got: dict, wall: float, peak_mib: int, smi,
               dev: str = "cuda") -> tuple:
    """``train_pods`` from the launch's pod runs: (a) = (b) bit for bit,
    the flat twin = its per-leaf run bit for bit, each rank of (a) held to
    the meta prediction (collectives and bytes a run and a round exact, the
    kernels' launches exact, the peak within DRYRUN_PEAK_RTOL), the
    round's parts, and (d) against the stacked CPU run of the plain
    versions (MODEL_RTOL; η 2% off must exceed it). Returns the phase's
    line and the launches by phase (rank 0's)."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    pred = DRY["train_pods"]
    a, b = got["mamba2/fsdp"], got["mamba2/repl"]
    require(same_run(a, b), "train_pods: the pod run differs from its "
            f"data-replicated run: {a['losses']} vs {b['losses']}, "
            f"{a['state_digest']} vs {b['state_digest']}")
    require(all(math.isfinite(v) for v in a["losses"])
            and a["sync_steps"] == list(range(
                POD_OPT["H"] - 1, POD_RUN["steps"], POD_OPT["H"]))
            and a["n_workers"] == 2,
            f"train_pods: losses {a['losses']}, syncs {a['sync_steps']}")
    fa, ff = got["mamba2_flat/fsdp"], got["mamba2_flat/flat"]
    require(same_run(fa, ff), "train_pods: the flat twin differs from its "
            f"per-leaf run: {fa['losses']} vs {ff['losses']}")
    steps = POD_RUN["steps"]
    rounds = len(a["sync_steps"])
    local = steps - rounds
    lp, sp = pred["local_step"], pred["sync_step"]
    ranks = []
    for rep, rnd, rep_b in zip(a["ranks"], a["rank_rounds"], b["ranks"]):
        moved = {"wire": {"n": rep["collectives"], "bytes": rep["wire_bytes"]},
                 "side": {"n": rep["side_collectives"],
                          "bytes": rep["side_bytes"]}}
        want = {k: {q: local * lp["counters"][k][q]
                    + rounds * sp["counters"][k][q] for q in ("n", "bytes")}
                for k in ("wire", "side")}
        require(moved == want, f"train_pods: rank {rep['rank']} moved "
                f"{moved}; the dry-run predicted {want}")
        r = rnd["round"]
        require({"n": r["n"] / rounds, "bytes": r["bytes"] / rounds}
                == pred["round"], f"train_pods: rank {rep['rank']}'s round "
                f"moved {r['n']} collectives, {r['bytes']} B in {rounds} "
                f"rounds; predicted {pred['round']} a round")
        kernels = {}
        for v, n in ((lp, local), (sp, rounds)):
            for k, c in v["kernels"].items():
                kernels[k] = kernels.get(k, 0) + n * c
        if dev == "cuda":
            require_launches(rep["launches"], **kernels)
        require(rep["state_bytes"] == pred["state_bytes"],
                f"train_pods: rank {rep['rank']} holds {rep['state_bytes']}"
                f" B of state, predicted {pred['state_bytes']}")
        peak = (rep["max_memory_allocated"] or 0) - rnd["allocated_at_start"]
        err = abs(pred["peak_bytes"] - peak) / max(peak, 1)
        if dev == "cuda":
            require(err <= DRYRUN_PEAK_RTOL, f"train_pods: rank "
                    f"{rep['rank']} peaked at {peak} B, predicted "
                    f"{pred['peak_bytes']} ({err:.3f} off)")
        sync_ms = [1e3 * rep["step_s"][i] for i in a["sync_steps"]]
        ranks.append({
            "rank": rep["rank"], "worker": rep["worker"],
            "route": rep["route"],
            "step_ms": [1e3 * t for t in rep["step_s"]],
            "sync_step_ms": sync_ms,
            "replicated_step_ms": [1e3 * t for t in rep_b["step_s"]],
            "collectives": moved, "collectives_predicted": want,
            "round_collectives": r["n"] / rounds,
            "round_wire_bytes": r["bytes"] / rounds,
            "round_ms": {k: 1e3 * v / rounds for k, v in r["seconds"].items()
                         if k != "gather"},
            "fsdp_gather_ms_per_step": 1e3 * (rep["round_s"]["gather"]
                                              / steps),
            "grad_mean_ms_per_step": {
                k: 1e3 * (rep["round_s"][k] - r["seconds"][k]) / steps
                for k in ("d2h", "wire", "h2d", "decode_sum")},
            "launches": rep["launches"], "launches_predicted": kernels,
            "state_bytes": rep["state_bytes"],
            "replicated_state_bytes": rep_b["state_bytes"],
            "max_memory_allocated_gb": peak / 1e9,
            "peak_predicted_gb": pred["peak_bytes"] / 1e9,
            "peak_rel_err": err,
            "replicated_max_memory_allocated_gb":
                (rep_b["max_memory_allocated"] or 0) / 1e9})
    # (d): reduced phi3.5-moe against the stacked run on the CPU
    phi = {}
    small = dataclasses.replace(reduced(get_arch(POD_PLAN_ARCH)),
                                param_dtype="float32")
    base = tree_map(lambda t: t.cpu(), build_model(small).init(
        torch.Generator(dev).manual_seed(0)))
    shape = ShapeConfig("t", seq_len=POD_PHI["seq"],
                        global_batch=POD_PHI["batch"], kind="train")

    def stacked(lr):
        return train_loop(small, shape, OptimizerConfig(**dict(
            POD_OPT, lr=lr)), steps=POD_PHI["steps"], n_workers=2,
            verbose=False, device="cpu", init_params=base).losses
    cpu, cpu_wrong = stacked(POD_OPT["lr"]), stacked(POD_OPT["lr"] * 1.02)
    wrong = max_rel(cpu_wrong, cpu)
    for name in ("phi/2x2x1", "phi/2x1x2"):
        r = got[name]
        err = max_rel(r["losses"], cpu)
        require(err <= MODEL_RTOL, f"train_pods {name}: the card's losses "
                f"{r['losses']} vs the CPU's {cpu} ({err})")
        require(max_rel(r["losses"], cpu_wrong) > MODEL_RTOL,
                f"train_pods {name}: η 2% off passes")
        if dev == "cuda":
            require(r["ranks"][0]["launches"]["fused_ef"] > 0,
                    f"train_pods {name}: {r['ranks'][0]['launches']}")
        phi[name] = {"losses": r["losses"], "rel_err_vs_cpu": err,
                     "sync_steps": r["sync_steps"],
                     "launches": r["ranks"][0]["launches"]}
    flat_launches = ff["ranks"][0]["launches"]
    if dev == "cuda":
        require(all(flat_launches[k] > 0 for k in (
            "flat_fused_update", "flat_ef", "dequantize_blocks")),
            f"train_pods flat: launches {flat_launches}")
    line = {"grid": POD_GRID, "plan": dataclasses.asdict(pod_plan()),
            "arch": POD_RUN["arch"], "params": pod_param_count(),
            "dtype": POD_RUN["dtype"], "tokens_per_step":
                POD_RUN["batch"] * POD_RUN["seq"], "steps": steps,
            "losses": a["losses"], "sync_steps": a["sync_steps"],
            "equal_to_replicated": True, "state_digest": a["state_digest"],
            "comm_bytes_total": a["comm_bytes_total"], "ranks": ranks,
            "flat": {"layers": POD_FLAT_LAYERS, "equal_to_per_leaf": True,
                     "losses": ff["losses"], "launches": flat_launches,
                     "step_ms": [1e3 * t for t in ff["ranks"][0]["step_s"]],
                     "per_leaf_step_ms": [1e3 * t for t in
                                          fa["ranks"][0]["step_s"]]},
            "phi_reduced": {"runs": phi, "cpu_losses": cpu,
                            "cpu_eta_2pct_high_rel": wrong,
                            "tol": MODEL_RTOL},
            "prediction": {k: pred[k] for k in ("state_bytes", "peak_bytes",
                                                "round", "round_accounting")},
            "launch_wall_s": wall,
            "card_memory_used_peak_gb": peak_mib * 2**20 / 1e9,
            "nvidia_smi": smi, "seconds": time.perf_counter() - t0}
    by_phase = {"train_pods": a["ranks"][0]["launches"],
                "train_pods_flat": flat_launches}
    return line, by_phase


def pod_param_count() -> int:
    from repro_torch.models.counting import count_params
    return count_params(pod_cfg())


# ---- slice 14: the dry-run held against the card, and the examples ------ #
# a prediction's peak of live bytes against the card's max_memory_allocated
DRYRUN_PEAK_RTOL = 0.10
# the dry-run's predictions (phase ``dryrun``), read by the later phases
# that hold them against the card
DRY = {}
# serve_dense's decode step and prompt, score_dense's forward
DENSE_DECODE = dict(batch=8, prompt=512, new=32)
DENSE_SCORE = dict(batch=2, seq=4096)


def _walk_summary(cost, report=None) -> dict:
    """A StepCost (and its roofline) as the phase lines give it."""
    out = {"flops": cost.flops, "matmul_flops": cost.matmul_flops,
           "bytes": cost.bytes, "n_ops": sum(cost.ops.values()),
           "kernels": dict(cost.kernels),
           "collectives": {k: v for k, v in cost.coll_counts.items() if v},
           "resident_bytes": cost.resident_bytes,
           "peak_bytes": cost.peak_bytes, "walk_s": cost.seconds}
    if report is not None:
        out.update(t_compute_ms=1e3 * report.t_compute,
                   t_memory_ms=1e3 * report.t_memory,
                   t_collective_ms=1e3 * report.t_collective,
                   dominant=report.dominant,
                   roofline_step_ms=1e3 * report.step_time)
    return out


def _roofline(cost, name):
    from repro_torch.roofline import analyze
    return analyze(cost, arch=name, shape_name="chip_smoke", mesh_name="1",
                   n_chips=1, model_flops_total=0.0)


def biglstm_programs(device):
    """The ``full`` phase's per-leaf run (2 workers x 32 x 20 tokens,
    int8, the kernels) as programs on ``device``, its weights and state,
    and a batch of its shape."""
    import torch
    from repro_torch.configs import OptimizerConfig, get_arch
    from repro_torch.launch.steps import build_train_programs
    from repro_torch.models import build_model
    cfg = get_arch("biglstm")
    oc = OptimizerConfig(name="local_adaalter", lr=0.5, H=4,
                         warmup_steps=100, compression="int8",
                         use_kernels=True)
    progs = build_train_programs(cfg, oc, n_workers=2, device=device)
    base = build_model(cfg).init(None, "meta") if device == "meta" else None
    params, state = progs.init_fn(0, base=base)
    # int32 tokens, as the synthetic stream draws them
    tok = (torch.empty((2, 32, 20), dtype=torch.int32, device="meta")
           if device == "meta" else torch.randint(
               0, cfg.vocab_size, (2, 32, 20), device=device,
               dtype=torch.int32,
               generator=torch.Generator(device).manual_seed(0)))
    return progs, params, state, {"tokens": tok, "labels": tok}


def dense_decode_inputs(cfg, params_device):
    """serve_dense's decode step: the programs of batch 8 at a cache of
    prompt 512 + 32 new, a zero cache, one token a sequence at 512."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.serving import build_serve_programs
    from repro_torch.models import build_model
    d = DENSE_DECODE
    shape = ShapeConfig("decode", seq_len=d["prompt"] + d["new"],
                        global_batch=d["batch"], kind="decode")
    progs = build_serve_programs(cfg, shape)
    cache = build_model(cfg).init_cache(d["batch"], progs.cache_len,
                                        device=params_device)
    token = torch.zeros((d["batch"], 1), dtype=torch.int32,
                        device=params_device)
    pos = torch.full((d["batch"],), d["prompt"], dtype=torch.int32,
                     device=params_device)
    return progs, cache, token, pos


def dryrun_predictions() -> dict:
    """The package's dry-run (``roofline.step_cost`` on the meta device,
    ``launch/dryrun.py`` with a DryGroup for the runs on ranks) of five
    runs the script makes, before any of them runs: the ``full`` phase's
    Big LSTM local and sync step; score_dense's qwen2-7b forward (2 x
    4096); one serve_dense decode step (batch 8, from 512); a
    train_fsdp_tp qwen2-7b rank (FSDP_TP_TRAIN's depth, 2 x 2, Alg. 3);
    one serve_tp decode step on 1 x 2 (TP_SERVE_LAYERS of 28 layers); the
    forward and the decode step at score_dense's depth (DEPTH_CUTS). Each
    with its ops,
    FLOPs, bytes, kernels, resident and peak bytes, and its roofline on
    the H100 (modeled, from the data sheet)."""
    import torch
    from repro_torch.configs import OptimizerConfig, ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import resolve_plan
    from repro_torch.launch.serving import serve_plan
    from repro_torch.models import build_model
    from repro_torch.roofline import step_cost
    t0 = time.perf_counter()
    out = {}
    progs, params, state, batch = biglstm_programs("meta")
    for name, fn in (("biglstm_local_step", progs.local_step),
                     ("biglstm_sync_step", progs.sync_step)):
        cost = step_cost(fn, params, state, batch)
        cost.result = None
        DRY[name] = cost
        out[name] = _walk_summary(cost, _roofline(cost, "biglstm"))
    del progs, params, state, batch
    qwen = get_arch("qwen2-7b")
    dense = dataclasses.replace(qwen, **DEPTH_CUTS["qwen2-7b"])
    model = build_model(dense)
    params = model.init(None, "meta")
    tok = torch.empty((DENSE_SCORE["batch"], DENSE_SCORE["seq"]),
                      dtype=torch.int32, device="meta")   # SyntheticLM's
    with torch.inference_mode():
        cost = step_cost(model.logits_fn, params, {"tokens": tok})
        cost.result = None
        DRY["dense_forward"] = cost
        out["dense_forward"] = _walk_summary(cost, _roofline(cost, "qwen2-7b"))
        sprogs, cache, token, pos = dense_decode_inputs(dense, "meta")
        cost = step_cost(sprogs.decode_step, params, cache, token, pos)
        cost.result = None
        DRY["dense_decode"] = cost
        out["dense_decode"] = _walk_summary(cost, _roofline(cost,
                                                            "qwen2-7b"))
    del params, cache
    label, _, cut, opt, _steps, lr, wire, plan = fsdp_tp_train_cfgs()[0]
    walks, _, resident, _ = dryrun.train_walks(
        cut, ShapeConfig("t", seq_len=512, global_batch=4, kind="train"),
        OptimizerConfig(**fsdp_tp_opt(opt, lr, wire)), FSDP_TP_GRID, plan,
        variants=("local_step",))
    cost, counters, _ = walks["local_step"]
    DRY["train_fsdp_tp"] = {label: {"counters": counters,
                                    "state_bytes": sum(resident.values())}}
    out["train_fsdp_tp"] = {"label": label, "grid": FSDP_TP_GRID,
                            "counters": counters, "resident": resident,
                            **_walk_summary(cost)}
    q_tp = dataclasses.replace(qwen, n_layers=TP_SERVE_LAYERS)
    shape = ShapeConfig("decode", seq_len=SERVE_PROMPT + TP_SERVE_NEW,
                        global_batch=8, kind="decode")
    _, cost, counters, _, _, resident, _ = dryrun.serve_walk(
        q_tp, shape, TP_GRID, serve_plan(qwen, TP_GRID))
    DRY["serve_tp_decode"] = {"counters": counters, "resident": resident}
    out["serve_tp_decode"] = {"grid": TP_GRID, "layers": TP_SERVE_LAYERS,
                              "counters": counters, "resident": resident,
                              **_walk_summary(cost)}
    require(resolve_plan(qwen, FSDP_TP_GRID, optimizer="adaalter") == plan,
            "train_fsdp_tp's plan moved")
    DRY["train_pods"] = pod_prediction()
    out["train_pods"] = {"grid": POD_GRID, **DRY["train_pods"]}
    out["seconds"] = time.perf_counter() - t0
    return out


def allocator_slack(args) -> int:
    """The most the caching allocator counts above the bytes of the card
    storages in ``args``: each block rounded up to 512 B, and a large
    block keeping its segment's tail where that is under 1 MiB (the
    allocator splits off only a remainder of 1 MiB or more)."""
    import torch
    from repro_torch.tree import leaves
    seen = {}
    for t in leaves(args):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(511 if n < (1 << 20) else (1 << 20) for n in seen.values())


def hold_walk(name, pred, fn, *args, resident_measured=None) -> dict:
    """``fn(*args)`` on the card against its meta-device prediction
    ``pred`` (a StepCost): a warm call, a timed call with the allocator's
    peak reset around it, then the call under the walk. The walk on the
    card must see the prediction's ops, FLOPs, bytes and kernels; the
    card's resident bytes (``resident_measured``: memory_allocated's rise
    over the arguments' creation) equal the prediction's to the
    allocator's rounding (:func:`allocator_slack`); the timed call's peak
    (the allocator's, less what else was alive) within DRYRUN_PEAK_RTOL
    of the predicted peak. Reports the walked call's peak beside it, and
    the measured wall beside the roofline's step time (no gate)."""
    import torch
    from repro_torch.roofline import step_cost
    fn(*args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card = step_cost(fn, *args)
    torch.cuda.synchronize()
    walked_peak = torch.cuda.max_memory_allocated()
    card.result = None
    others = before - card.resident_bytes      # alive beside the arguments
    measured_peak = peak - others
    same = {"ops": card.ops == pred.ops, "flops": card.flops == pred.flops,
            "bytes": card.bytes == pred.bytes,
            "kernels": card.kernels == pred.kernels}
    diff = {k: (pred.ops.get(k), card.ops.get(k))
            for k in set(pred.ops) | set(card.ops)
            if pred.ops.get(k) != card.ops.get(k)}
    require(all(same.values()), f"dryrun {name}: the walk on the card "
            f"differs from the meta walk ({same}; ops meta/card {diff}; "
            f"flops {pred.flops}/{card.flops}, bytes {pred.bytes}/"
            f"{card.bytes}, kernels {pred.kernels}/{card.kernels})")
    require(card.resident_bytes == pred.resident_bytes,
            f"dryrun {name}: the arguments hold {card.resident_bytes} B on "
            f"the card, {pred.resident_bytes} predicted")
    if resident_measured is not None:
        slack = allocator_slack(args)
        require(0 <= resident_measured - pred.resident_bytes <= slack,
                f"dryrun {name}: memory_allocated rose {resident_measured} "
                f"B over the arguments, {pred.resident_bytes} predicted "
                f"(the allocator's rounding: at most {slack} B)")
    err = abs(pred.peak_bytes - measured_peak) / measured_peak
    require(err <= DRYRUN_PEAK_RTOL,
            f"dryrun {name}: predicted peak {pred.peak_bytes} B, the card "
            f"{measured_peak} B ({err:.3f} off)")
    rep = _roofline(pred, name)
    return {"ops_flops_bytes_kernels_equal": True,
            "resident_bytes": pred.resident_bytes,
            "resident_measured": resident_measured,
            "peak_bytes_predicted": pred.peak_bytes,
            "peak_bytes_measured": measured_peak,
            "max_memory_allocated": peak,
            "peak_bytes_walked_call": walked_peak - others,
            "peak_rel_err": err,
            "peak_tol": DRYRUN_PEAK_RTOL, "wall_ms": 1e3 * wall,
            "roofline_step_ms": 1e3 * rep.step_time,
            "dominant": rep.dominant,
            "roofline_share": rep.step_time / wall if wall else None,
            "walk_on_card_s": card.seconds}


def dryrun_card_biglstm() -> dict:
    """The Big LSTM predictions held against the card: its programs
    initialised on the card (memory_allocated's rise against the
    predicted resident bytes), then the local and the sync step through
    :func:`hold_walk`."""
    import torch
    free_card()
    m0 = torch.cuda.memory_allocated()
    progs, params, state, batch = biglstm_programs("cuda")
    torch.cuda.synchronize()
    rose = torch.cuda.memory_allocated() - m0
    out = {}
    for name, fn in (("biglstm_local_step", progs.local_step),
                     ("biglstm_sync_step", progs.sync_step)):
        out[name] = hold_walk(name, DRY[name], fn, params, state, batch,
                              resident_measured=rose)
    del progs, params, state, batch
    free_card()
    return out


def dryrun_card_dense(params, rose) -> dict:
    """score_dense's forward and one serve_dense decode step held against
    their predictions on the card (``params``: score_dense's weights,
    whose creation raised memory_allocated by ``rose``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    qwen = dataclasses.replace(get_arch("qwen2-7b"),
                               **DEPTH_CUTS["qwen2-7b"])
    model = build_model(qwen)
    tok = torch.from_numpy(SyntheticLM(
        vocab_size=qwen.vocab_size, seq_len=DENSE_SCORE["seq"],
        seed=0).worker_batch(0, 0, DENSE_SCORE["batch"])["tokens"]).cuda()
    out = {}
    with torch.inference_mode():
        out["dense_forward"] = hold_walk(
            "dense_forward", DRY["dense_forward"], model.logits_fn, params,
            {"tokens": tok}, resident_measured=rose + tok.numel()
            * tok.element_size())
        del tok
        torch.cuda.empty_cache()
        progs, cache, token, pos = dense_decode_inputs(qwen, "cuda")
        out["dense_decode"] = hold_walk(
            "dense_decode", DRY["dense_decode"], progs.decode_step, params,
            cache, token, pos)
    del cache
    torch.cuda.empty_cache()
    return out


# ---- side work: what times nothing, beside the examples ----------------- #
# The CPU halves of the card-against-CPU checks depend only on seeds, and
# reference_dense (card and CPU) times nothing, so they run in processes
# of their own while the examples run and the kernels build (nothing is
# timed then), and the phases hold their card halves to them (SIDE, filled
# by finish_side before the kernels phase): a process a group, its parts in
# turn. They run with the torch thread count this script has (its
# intra-op default): a CPU reduction's last bits depend on it, and the
# tolerances were set on runs with it
SIDE_GROUPS = (("reference", "train_families", "tp_grid"),
               ("reference_dense",))
SIDE = {}
# the reference phase's setups: reduced Big LSTM per leaf and flat, with
# the one-pass and the three-pass encode
REFERENCE_SETUPS = {"per_leaf": {}, "flat": {"flat": True},
                    "per_leaf_unfused": {"sync_fused": False},
                    "flat_unfused": {"flat": True, "sync_fused": False}}
REFERENCE_LR = 2.0
TRAIN_FAMILIES = ("hymba-1.5b", "qwen2-7b", "phi3.5-moe-42b-a6.6b")


def reduced_losses(dev, lr, **kw) -> list:
    """The reference phase's run: reduced Big LSTM in float32 (weights
    from seed 1 on the CPU), 2 workers, int8 H = 4 with the kernels, 8
    steps at ``lr`` on ``dev``: its losses."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                     get_arch, reduced)
    from repro_torch.launch.train import train_loop
    from repro_torch.models.lstm import init_lstm
    small = dataclasses.replace(reduced(get_arch("biglstm")),
                                param_dtype="float32")
    base = init_lstm(torch.Generator().manual_seed(1), small)
    shape = ShapeConfig("smoke", seq_len=16, global_batch=8, kind="train")
    oc = OptimizerConfig(compression="int8", use_kernels=True, H=4,
                         lr=lr, warmup_steps=0, **kw)
    res = train_loop(small, shape, oc, steps=TRAIN_STEPS, n_workers=2,
                     verbose=False, device=dev, init_params=base)
    require(res.sync_steps == [3, 7],
            f"reduced run {kw} on {dev}: sync steps {res.sync_steps}")
    return res.losses


def family_run(arch: str, dev, eta):
    """reference_train_families' run of reduced ``arch`` in float32
    (weights from seed 1 on the CPU): Local AdaAlter, 2 workers, int8 H =
    4 with the kernels, 8 steps at ``eta`` on ``dev``. Returns (its
    TrainResult, its leaf count)."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                     get_arch, reduced)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")
    base = build_model(cfg).init(torch.Generator().manual_seed(1))
    shape = ShapeConfig("smoke", seq_len=16, global_batch=8, kind="train")
    oc = OptimizerConfig(compression="int8", use_kernels=True, H=4,
                         lr=eta, warmup_steps=0)
    return train_loop(cfg, shape, oc, steps=TRAIN_STEPS, n_workers=2,
                      verbose=False, device=dev,
                      init_params=base), len(leaves(base))


def tp_grid_cpu(arch: str) -> dict:
    """tp_grid's CPU runs of reduced ``arch`` in float32 from the ranks'
    weights (seed 0 on the card's generator), at TP_GRID_OPT's lr and 2%
    above it: their losses."""
    import torch
    from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                     get_arch, reduced)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    opt = TP_GRID_OPT
    cfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")
    cpu_base = tree_map(lambda t: t.cpu(), build_model(cfg).init(
        torch.Generator("cuda").manual_seed(0)))
    shape = ShapeConfig("tp_grid", seq_len=16, global_batch=8, kind="train")
    return {key: train_loop(cfg, shape, OptimizerConfig(**{**opt, "lr": lr}),
                            steps=tp_grid_steps(arch), n_workers=2,
                            verbose=False, device="cpu",
                            init_params=cpu_base).losses
            for key, lr in (("lr", opt["lr"]),
                            ("eta_2pct_high", opt["lr"] * 1.02))}


def side_work(name: str) -> dict:
    """One group's side work, JSON-able."""
    if name == "reference":
        return {setup: {"cpu": reduced_losses("cpu", REFERENCE_LR, **kw),
                        "cpu_eta_2pct_high": reduced_losses(
                            "cpu", REFERENCE_LR * 1.02, **kw)}
                for setup, kw in REFERENCE_SETUPS.items()}
    if name == "train_families":
        out = {}
        for arch in TRAIN_FAMILIES:
            cpu, _ = family_run(arch, "cpu", REFERENCE_LR)
            wrong, _ = family_run(arch, "cpu", REFERENCE_LR * 1.02)
            out[arch] = {"losses": cpu.losses,
                         "losses_eta_2pct_high": wrong.losses,
                         **{k: getattr(cpu, k) for k in (
                             "sync_steps", "comm_bytes_total",
                             "comm_bytes_modeled")}}
        return out
    if name == "tp_grid":
        return {arch: tp_grid_cpu(arch) for arch in TP_GRID_ARCHS}
    if name == "reference_dense":      # with this process's counters
        from repro_torch.kernels import (adaalter_update as au, quantize as
                                         qz, ssd_scan, sync_fused as sf)
        return reference_dense({
            "adaalter_update": au.launches, "fused_ef": sf.launches,
            "flat_fused_update": au.flat_launches,
            "flat_ef": sf.flat_launches,
            "quantize_blocks": qz.quantize_launches,
            "dequantize_blocks": qz.dequantize_launches,
            "ssd_scan": ssd_scan.launches})
    raise KeyError(name)


def side_main(names: str, out: str) -> int:
    """``python3 chip_smoke.py --side NAME[,NAME] OUT``: the named side
    work in turn, each into ``OUT.NAME.json`` as it ends (run by
    start_side)."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    torch.backends.cuda.matmul.allow_tf32 = False     # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    for name in names.split(","):
        t0 = time.perf_counter()
        got = {"result": side_work(name),
               "seconds": time.perf_counter() - t0}
        part = Path(f"{out}.{name}.json")
        part.with_suffix(".tmp").write_text(json.dumps(got))
        part.with_suffix(".tmp").rename(part)
    return 0


def start_side(root: Path, threads: int) -> dict:
    """Start a process for each group of SIDE_GROUPS, each with
    ``threads`` torch threads (the card's work goes on meanwhile);
    :func:`finish_side` waits for their parts."""
    tmp = tempfile.TemporaryDirectory()
    # threads that wait sleep: the window's processes share 8 cores
    env = {**os.environ, "OMP_NUM_THREADS": str(threads),
           "OMP_WAIT_POLICY": "PASSIVE"}
    procs = {}
    for group in SIDE_GROUPS:
        out = str(Path(tmp.name) / group[0])
        with open(out + ".log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, str(root / "chip_smoke.py"), "--side",
                 ",".join(group), out], cwd=str(root), env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        proc.log = out + ".log"
        procs.update({name: (proc, f"{out}.{name}.json") for name in group})
    atexit.register(stop_processes, {p for p, _ in procs.values()})
    return {"procs": procs, "tmp": tmp, "t0": time.perf_counter()}


def finish_side(started: dict, names=None) -> dict:
    """Wait for the side work ``names`` (default: all) that
    :func:`start_side` started and put the results in SIDE; a process
    that ends without a part fails the script. With ``names`` None, each
    process must also have exited 0. Returns each part's seconds."""
    seconds = {}
    for name, (proc, path) in started["procs"].items():
        if (names is not None and name not in names) or name in SIDE:
            continue
        while not Path(path).exists():
            if proc.poll() is not None and not Path(path).exists():
                require(False, f"the side work {name} ended without its "
                        f"result, exit {proc.returncode}:\n"
                        f"{Path(proc.log).read_text()[-3000:]}")
            time.sleep(0.1)
        got = json.loads(Path(path).read_text())
        SIDE[name], seconds[name] = got["result"], got["seconds"]
    if names is None:
        for proc in {p for p, _ in started["procs"].values()}:
            proc.wait(timeout=600)
            require(proc.returncode == 0, f"the side work exited "
                    f"{proc.returncode}:\n"
                    f"{Path(proc.log).read_text()[-3000:]}")
    return seconds


def _regress_fields(value, path: str, out: dict) -> None:
    """The fields of a phase line that the regress phase's row keeps,
    under their dotted paths (a list of dicts by index): walls (``*_ms``,
    ``*_s``), collective counts, byte counts, and the sync steps with
    their count."""
    if isinstance(value, dict):
        for k, v in value.items():
            _regress_fields(v, f"{path}.{k}" if path else str(k), out)
        return
    if isinstance(value, list) and value and all(isinstance(v, dict)
                                                 for v in value):
        for i, v in enumerate(value):
            _regress_fields(v, f"{path}.{i}", out)
        return
    leaf = path.rsplit(".", 1)[-1]
    number = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
    if leaf == "sync_steps" and isinstance(value, list):
        out[path] = value
        out[path[:len(path) - len(leaf)] + "sync_rounds"] = len(value)
    elif leaf.endswith(("_ms", "_s")) and (number(value) or (
            isinstance(value, list) and value and all(map(number, value)))):
        out[path] = value
    elif number(value) and ("collectives" in leaf or "bytes" in leaf):
        out[path] = value


def regress_rows(by_phase: dict) -> list:
    """One row a phase line emitted so far (``bench`` chip_smoke, ``mode``
    the phase): the kernels' launches in it (``by_phase``), its seconds
    (``phase_s``) and :func:`_regress_fields` of its line."""
    seconds = phases_s()
    rows = []
    for line in PHASE_LINES:
        name = line["phase"]
        fields = {}
        _regress_fields({k: v for k, v in line.items() if k != "phase"}, "",
                        fields)
        rows.append({"bench": "chip_smoke", "mode": name,
                     "launches": dict(by_phase.get(name, {})),
                     "phase_s": seconds[name], **fields})
    return rows


def regress_phase(root: Path, by_phase: dict) -> dict:
    """The port's bench-regression gate (``python -m
    repro_torch.obs.regress``) on this run's own rows (:func:`regress_rows`)
    written as BENCH_chip_smoke.json into a baseline and a fresh
    directory, four ways at once, each a process: the rows unchanged (exit
    0), one launch count one higher (exit 1, that field named in the
    report), every wall doubled (exit 0: walls are not compared) and one
    row dropped (exit 1, "missing"). Nothing under benchmarks/ is read."""
    import copy
    rows = regress_rows(by_phase)
    drift_row = next(i for i, r in enumerate(rows) if r["launches"])
    kernel = sorted(rows[drift_row]["launches"])[0]
    drifted = copy.deepcopy(rows)
    drifted[drift_row]["launches"][kernel] += 1
    doubled = copy.deepcopy(rows)
    for row in doubled:
        for k, v in row.items():
            if k.endswith(("_ms", "_s")):
                row[k] = [2 * x for x in v] if isinstance(v, list) else 2 * v
    dropped = rows[:drift_row] + rows[drift_row + 1:]
    cases = {"identical": (rows, 0), "launch_plus_1": (drifted, 1),
             "walls_doubled": (doubled, 0), "row_dropped": (dropped, 1)}
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "baseline"
        base.mkdir()
        (base / "BENCH_chip_smoke.json").write_text(json.dumps(rows))
        procs = {}
        for case, (fresh_rows, _) in cases.items():
            fresh = Path(tmp) / case
            fresh.mkdir()
            (fresh / "BENCH_chip_smoke.json").write_text(
                json.dumps(fresh_rows))
            procs[case] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.obs.regress",
                 "--baselines", str(base), "--fresh", str(fresh),
                 "--report", str(Path(tmp) / f"{case}.report.json")],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        codes, reports = {}, {}
        for case, p in procs.items():
            text, _ = p.communicate(timeout=300)
            codes[case] = p.returncode
            reports[case] = json.loads(
                (Path(tmp) / f"{case}.report.json").read_text())
            require(p.returncode == cases[case][1],
                    f"regress {case}: exit {p.returncode}, want "
                    f"{cases[case][1]}:\n{text[-3000:]}")
    field = f"launches.{kernel}"
    named = [f["reason"] for f in reports["launch_plus_1"]["failures"]]
    require(len(named) == 1 and named[0].startswith(field + ":"),
            f"regress: a launch count of {kernel} one higher in "
            f"{rows[drift_row]['mode']} reported as {named}")
    missing = [f["reason"] for f in reports["row_dropped"]["failures"]]
    require(len(missing) == 1 and "missing" in missing[0],
            f"regress: the dropped row reported as {missing}")
    require(not reports["identical"]["failures"]
            and not reports["walls_doubled"]["failures"],
            f"regress: failures on unchanged structure: "
            f"{reports['identical']} {reports['walls_doubled']}")
    compared = sum(1 for r in rows for k in _flat_keys(r)
                   if _gate_tolerance(k) is not None)
    return {"rows": len(rows), "fields": sum(len(_flat_keys(r))
                                             for r in rows),
            "fields_compared": compared,
            "launch_drift": {"phase": rows[drift_row]["mode"],
                             "field": field, "reason": named[0]},
            "dropped": {"phase": rows[drift_row]["mode"],
                        "reason": missing[0]},
            "exit_codes": codes}


def _flat_keys(row: dict) -> list:
    """``row``'s fields as the gate flattens them (dicts by dotted path)."""
    out = []
    for k, v in row.items():
        out += ([f"{k}.{s}" for s in _flat_keys(v)] if isinstance(v, dict)
                else [k])
    return out


def _gate_tolerance(field: str):
    from repro_torch.obs.regress import IDENTITY_KEYS, field_tolerance
    return None if field in IDENTITY_KEYS else field_tolerance(field)


EXAMPLE_RUNS = (
    ("quickstart", ["quickstart.py"]),
    ("serve_batched", ["serve_batched.py"]),
    ("reproduce_paper", ["reproduce_paper.py", "--steps", "16"]),
)
# train_100m: 4 steps with a checkpoint at 4, then resumed to 8 (10 and 20
# before the 600 s budget)
EXAMPLE_100M = dict(first=4, resumed=8, every=4)


def stop_processes(procs) -> None:
    """Kill each process of ``procs`` still running (with its session,
    where it leads one)."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, 9)
            except (ProcessLookupError, PermissionError):
                p.kill()


def start_examples(root: Path) -> dict:
    """Start the four examples of ``examples/torch/`` on the card, each a
    process of its own, all together: quickstart and serve_batched at
    their defaults, reproduce_paper at 16 steps, train_100m for
    EXAMPLE_100M's first steps with a checkpoint and then resumed (one
    shell running the two in turn). They run while the dry-run predicts and the kernels build,
    and :func:`finish_examples` waits for them before anything is timed
    on the card."""
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    ex = root / "examples" / "torch"
    tmp = tempfile.TemporaryDirectory()
    e = EXAMPLE_100M
    outs = Path(tmp.name) / "first.json", Path(tmp.name) / "resumed.json"
    common = [sys.executable, str(ex / "train_100m.py"), "--checkpoint-dir",
              str(Path(tmp.name) / "ck"), "--checkpoint-every",
              str(e["every"])]
    chain = " && ".join(" ".join(map(str, c)) for c in (
        common + ["--steps", str(e["first"]), "--out", str(outs[0])],
        common + ["--steps", str(e["resumed"]), "--out", str(outs[1])]))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ex / args[0]), *args[1:]], env=env,
        cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True) for name, args in EXAMPLE_RUNS}
    procs["train_100m"] = subprocess.Popen(
        ["bash", "-c", chain], env=env, cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    # a phase that fails before finish_examples leaves none running
    atexit.register(stop_processes, procs.values())
    t0, logs, ended = time.perf_counter(), {}, {}

    def watch(name, p):
        logs[name] = p.stdout.read()
        p.wait()
        ended[name] = time.perf_counter() - t0
    watchers = [threading.Thread(target=watch, args=item, daemon=True)
                for item in procs.items()]
    for w in watchers:
        w.start()
    return {"procs": procs, "tmp": tmp, "outs": outs, "t0": t0,
            "logs": logs, "ended": ended, "watchers": watchers}


def finish_examples(started: dict) -> dict:
    """Wait for the examples :func:`start_examples` started: each must
    exit 0, and train_100m's resumed run must start where the saved one
    stopped and continue its steps."""
    waited = time.perf_counter()
    procs, logs, ended = (started[k] for k in ("procs", "logs", "ended"))
    for w in started["watchers"]:
        w.join(timeout=max(1.0, 300 - (time.perf_counter() - waited)))
    stop_processes(procs.values())          # any still running past 300 s
    for w in started["watchers"]:
        w.join(timeout=30)
    for name, p in procs.items():
        require(p.returncode == 0, f"example {name} exited "
                f"{p.returncode}:\n{logs.get(name, '')[-3000:]}")
    first, resumed = (json.loads(x.read_text()) for x in started["outs"])
    started["tmp"].cleanup()
    e = EXAMPLE_100M
    require(first["start_step"] == 0 and first["steps"] == e["first"]
            and resumed["start_step"] == e["first"]
            and resumed["steps"] == e["resumed"] - e["first"]
            and f"restored checkpoint at step {e['first']}"
            in logs["train_100m"]
            and all(math.isfinite(v) for v in first["losses"]
                    + resumed["losses"]),
            f"train_100m's resume: {first} then {resumed}")
    now = time.perf_counter()
    return {"seconds": now - started["t0"], "waited_s": now - waited,
            "ended_s": ended,
            "train_100m": {"first": first, "resumed": resumed},
            "tails": {k: v.strip().splitlines()[-3:]
                      for k, v in logs.items()}}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    # the examples run on the card, and the CPU halves of the later
    # card-against-CPU checks in processes of their own, while the dry-run
    # predicts and the kernels build (finish_examples and
    # finish_side wait for them before any timing)
    examples = start_examples(root)
    side = start_side(root, torch.get_num_threads())
    sys.path.insert(0, str(root / "src"))
    global H100
    from repro_torch.hardware import H100
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.kernels import _build
    from repro_torch.kernels import adaalter_update as au
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import sync_fused as sf
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    from repro_torch.models.lstm import init_lstm

    # float32 products in full float32 everywhere (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"adaalter_update": au.launches, "fused_ef": sf.launches,
                "flat_fused_update": au.flat_launches,
                "flat_ef": sf.flat_launches,
                "quantize_blocks": qz.quantize_launches,
                "dequantize_blocks": qz.dequantize_launches,
                "ssd_scan": ssd.launches}

    # ---- device --------------------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- the build, while the dry-run predicts before anything runs --- #
    t0 = time.perf_counter()
    built = {}

    def build():
        try:
            built["log"] = _build.build()
        finally:
            built["seconds"] = time.perf_counter() - t0
    compiling = threading.Thread(target=build)
    compiling.start()
    emit({"phase": "dryrun", "nvidia_smi": smi, **dryrun_predictions()})
    compiling.join()
    require("log" in built, "the kernels' build failed (its error above)")
    _build.load()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": built["seconds"],
          "library": str(_build.library_path().relative_to(root)),
          "sources": [p.name for p in _build.sources()], "ptxas": ptxas})
    cfg = get_arch("biglstm")
    R, batch, seq = 2, 64, 20       # the full-width runs' workers and shape
    full = ShapeConfig("full", seq_len=seq, global_batch=batch, kind="train")
    # the launches of two and of four ranks start now, while nothing is
    # timed: their ranks import what they run, then wait for their
    # phases' go (start_launch)
    two = start_two_ranks(root, cfg, full)
    four = start_fsdp_tp_launch(root, four_rank_loops(cfg)[1], hold=True)

    # ---- reduced reference: card + kernels vs CPU + plain versions ------ #
    # (nothing here is timed: it runs beside the examples)
    # lr 2 makes the losses move enough that a wrong update shows: the same
    # run on the CPU with η 2% larger must fall outside the tolerance
    # (the CPU runs in their own process since the script started)
    small = dataclasses.replace(reduced(cfg), param_dtype="float32")
    base = init_lstm(torch.Generator().manual_seed(1), small)
    cuda = {name: reduced_losses("cuda", REFERENCE_LR, **kw)
            for name, kw in REFERENCE_SETUPS.items()}

    # ---- the other card-against-CPU checks, which time nothing -------- #
    # (they run beside the examples too, while the side work computes the
    # CPU halves: on reduced models, each checked to a tolerance or bit
    # for bit)
    emit({"phase": "flat_eq", "runs": [flat_equals_per_leaf(small, base, f)
                                       for f in (True, False)]})
    emit({"phase": "reference_ssm", **reference_ssm(ssd.launches)})
    emit({"phase": "reference_lstm_serve", **reference_lstm_serve(counters)})
    for name, check in (("reference_moe", reference_moe),
                        ("reference_cross", reference_cross),
                        ("reference_hybrid", reference_hybrid)):
        t0 = time.perf_counter()
        emit({"phase": name, **check(counters),
              "seconds": time.perf_counter() - t0})
    side_s = finish_side(side, ["reference"])
    rtol, reference = 1e-4, {}
    for name in REFERENCE_SETUPS:
        cpu = SIDE["reference"][name]["cpu"]
        cuda_l = cuda[name]
        rel = max_rel(cuda_l, cpu)
        rel_wrong = max_rel(SIDE["reference"][name][
            "cpu_eta_2pct_high"], cpu)
        require(rel <= rtol, f"reduced run {name}: losses differ by {rel} "
                "relative")
        require(rel_wrong > rtol, f"reduced run {name}: an η 2% off moves "
                f"the losses by only {rel_wrong}, within the tolerance")
        reference[name] = {"losses_cuda": cuda_l, "losses_cpu": cpu,
                           "max_rel_diff": rel,
                           "max_rel_diff_eta_2pct_high": rel_wrong}
    emit({"phase": "reference", "rtol": rtol, "setups": reference,
          "cpu_threads": torch.get_num_threads()})
    side_s.update(finish_side(side))
    emit({"phase": "reference_dense", **SIDE["reference_dense"]})
    t0 = time.perf_counter()
    emit({"phase": "reference_train_families",
          **reference_train_families(counters),
          "seconds": time.perf_counter() - t0})
    free_card()

    # the examples end before anything is timed
    emit({"phase": "examples", "nvidia_smi": smi,
          **finish_examples(examples), "side_s": side_s})
    side["tmp"].cleanup()

    # ---- kernels vs plain, at the full-width shapes of the paths -------- #
    V, P = cfg.vocab_size, cfg.lstm_proj
    gen = torch.Generator("cuda").manual_seed(0)
    upd = [check_update(gen, (R, V, P), torch.bfloat16),
           check_update(gen, (R, P, 4 * cfg.d_model), torch.float32)]
    torch.cuda.empty_cache()
    ef = [check_ef(gen, (R, V, P), torch.bfloat16, False),
          check_ef(gen, (R, V, P), torch.float32, True),
          check_ef(gen, (R, V), torch.bfloat16, False, timed=False),
          check_ef(gen, (R, V), torch.float32, True, timed=False)]
    torch.cuda.empty_cache()
    fs = full_plane(cfg, R)
    flat_upd = check_flat_update(gen, fs)
    torch.cuda.empty_cache()
    flat_ef = [check_flat_ef(gen, fs, "params"), check_flat_ef(gen, fs, "b2")]
    torch.cuda.empty_cache()
    quant = check_quantize(gen, (R, V, P))
    torch.cuda.empty_cache()
    mean = time_sync_mean(gen, cfg, fs)
    torch.cuda.empty_cache()
    # the SSD chunk scan at the mamba2-370m scoring shape (8 x 2048 tokens:
    # 32 chunks of 64, 32 heads of 64, state 128) and at a 32k-token
    # sequence (512 chunks, batch 1), after its product helper alone
    m2 = get_arch("mamba2-370m")
    score_dims = (8, 2048 // m2.ssm_chunk, m2.ssm_chunk, m2.n_ssm_heads,
                  m2.ssm_head_dim, m2.ssm_state)
    long_dims = (1, 32768 // m2.ssm_chunk) + score_dims[2:]
    mma = check_mma_selftest(gen)            # the helper alone, first
    ssd_checks = [check_ssd(gen, score_dims, torch.float32),
                  check_ssd(gen, score_dims, torch.bfloat16),
                  check_ssd(gen, long_dims, torch.float32)]
    ssd_partial = [check_ssd(gen, dims, dtype, timed=False)
                   for dims in SSD_PARTIAL_GROUP_SHAPES
                   for dtype in (torch.float32, torch.bfloat16)]
    # at hymba-1.5b's scoring shape (2 x 4096 tokens: 64 chunks of 64, 50
    # heads of 64, state 16): the last 8-head group holds 2 heads
    hy = get_arch("hymba-1.5b")
    hymba_dims = (2, 4096 // hy.ssm_chunk, hy.ssm_chunk, hy.n_ssm_heads,
                  hy.ssm_head_dim, hy.ssm_state)
    ssd_hymba = [check_ssd(gen, hymba_dims, dtype)
                 for dtype in (torch.float32, torch.bfloat16)]
    # rows 1-4 at the shapes that train_hybrid gives them: hymba's stacked
    # leaves and its plane
    hymba_train = check_tree_kernels(gen, hymba_train_cfg(), R)
    # rows 2 and 4 on each rank's sub-plane of train_sharded (1 worker x 2
    # shards), with its shard's sidecar rows, then rows 5 and 6
    fs2 = full_plane(cfg, 1, shards=2)
    sharded = {"update": [check_flat_update(gen, fs2, timed=False, shard=s)
                          for s in range(fs2.shards)]}
    torch.cuda.empty_cache()
    sharded["ef"] = [check_flat_ef(gen, fs2, half, timed=False, shard=s)
                     for s in range(fs2.shards) for half in ("params", "b2")]
    torch.cuda.empty_cache()
    # rows 5 and 6 on its sub-plane halves: the mean's decode a 2^26-element
    # chunk at a time, the shorter last chunk included
    sharded["codes"] = [check_subplane_codes(gen, fs2.shard_size)]
    # rows 2, 4, 5 and 6 at sharded_grid's sub-planes (reduced, 2 x 2)
    fsg = full_plane(reduced(cfg), 1, shards=2)
    sharded["grid_update"] = [check_flat_update(gen, fsg, timed=False,
                                                shard=s)
                              for s in range(fsg.shards)]
    sharded["grid_ef"] = [check_flat_ef(gen, fsg, half, timed=False, shard=s)
                          for s in range(fsg.shards)
                          for half in ("params", "b2")]
    sharded["grid_codes"] = [check_subplane_codes(gen, fsg.shard_size)]
    torch.cuda.empty_cache()
    # row 3 on every part shape train_fsdp_local's ranks encode whole
    fsdp_parts = check_fsdp_parts(gen, cfg)
    # rows 1, 3 and 6 on every part shape a train_tp rank holds, and a
    # train_tp_families rank (hymba's SSM parts, phi3.5-moe's experts
    # (1, 1, 8, 4096, 6400))
    tp_parts = check_tp_parts(gen, tp_train_cfg())
    tp_family_parts = [check_tp_parts(gen, family_cfg(arch, cut))
                       for _, arch, cut, *_ in TP_FAMILY_TRAIN]
    # row 3 on every tile shape train_fsdp_tp's phi3.5-moe ranks encode in
    # place (a tile's runs holding whole 256-blocks)
    fsdp_tp_parts = check_fsdp_tp_parts(gen)
    # rows 1, 3 and 6 on every tile shape a train_pods rank holds, rows 2
    # and 4 on the flat twin's sub-planes
    pod_parts = check_pod_parts(gen)
    # row 7 at a TP rank's heads, as serve_tp_families' scoring forward
    # gives them (1 x 2048 tokens; fp32 inputs): mamba2's 16 of 32 heads,
    # N 128, and hymba's 25 of 50, N 16 (a last 8-head group of 1)
    ssd_tp = [check_ssd(gen, (1, TP_FAMILY_SCORE_SEQ // c.ssm_chunk,
                              c.ssm_chunk, c.n_ssm_heads // 2,
                              c.ssm_head_dim, c.ssm_state), torch.float32)
              for c in (m2, hy)]
    sass = sass_tf32_mma_counts(_build.library_path())
    require(all(sass.get(f"{k}<{t}>", 0) > 0 for k in SSD_KERNELS[::2]
                for t in ("float", "bf16")),
            f"no TF32 tensor-core instruction in an SSD chunk kernel: {sass}")
    emit({"phase": "kernels", "nvidia_smi": smi, "update": upd, "ef": ef,
          "flat_update": flat_upd, "flat_ef": flat_ef, "quantize": quant,
          "sync_mean": mean, "mma_selftest": mma, "ssd": ssd_checks,
          "ssd_partial_head_groups": ssd_partial, "ssd_hymba": ssd_hymba,
          "hymba_train": hymba_train, "sharded_subplanes": sharded,
          "fsdp_parts": fsdp_parts, "tp_parts": tp_parts,
          "tp_family_parts": tp_family_parts,
          "fsdp_tp_tiles": fsdp_tp_parts, "pod_tiles": pod_parts,
          "ssd_tp_heads": ssd_tp,
          "ssd_sass_tf32_hmma": sass,
          "plane": {"plane_size": fs.plane_size, "real": fs.n_real,
                    "slots": fs.n_leaves, "buckets": fs.bucket_ranges()}})
    emit({"phase": "dryrun_card", "nvidia_smi": smi,
          **dryrun_card_biglstm()})

    # ---- flat = per-leaf on the card ------------------------------------ #
    # ---- full-width training through train_loop ------------------------- #
    shape = full
    n_leaves = 3 + 4 * cfg.n_layers

    def train(steps, **kw):
        """train_loop at full width, every launch count set to 0 just
        before and read just after."""
        oc = OptimizerConfig(name="local_adaalter", lr=0.5, H=4,
                             warmup_steps=100, compression="int8",
                             use_kernels=True, **kw)
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        res = train_loop(cfg, shape, oc, steps=steps, n_workers=R,
                         log_every=1, device="cuda", digest=True)
        launches = read_counts(counters)
        require(res.sync_steps == [3, 7][:steps // 4],
                f"sync steps {res.sync_steps} ({kw})")
        require(all(math.isfinite(v) for v in res.losses),
                f"non-finite loss ({kw})")
        require(abs(res.losses[0] - math.log(V)) <= 1.5,
                f"step-0 loss {res.losses[0]} vs ln V {math.log(V)} ({kw})")
        out = {"nvidia_smi": smi, "arch": cfg.name,
               "params": count_params(cfg), "workers": R,
               "global_batch": batch, "seq": seq, "steps": steps,
               "options": kw, "losses": res.losses,
               "sync_steps": res.sync_steps, "launches": launches,
               **warm_stats(res, batch, seq),
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "comm_bytes_total": res.comm_bytes_total,
               "state_digest": res.state_digest}
        return oc, out, launches

    oc_leaf, leaf, leaf_n = train(TRAIN_STEPS)
    require_launches(leaf_n, adaalter_update=n_leaves * TRAIN_STEPS,
                     fused_ef=2 * n_leaves * 2)
    emit({"phase": "train", **leaf})
    oc_flat, flat, flat_n = train(TRAIN_STEPS, flat=True)
    # one update launch a step; one EF launch per payload half per round
    require_launches(flat_n, flat_fused_update=TRAIN_STEPS, flat_ef=2 * 2)
    emit({"phase": "train_flat", **flat})
    _, unfused, unfused_n = train(4, sync_fused=False)
    require_launches(unfused_n, adaalter_update=n_leaves * 4,
                     quantize_blocks=2 * n_leaves,
                     dequantize_blocks=2 * n_leaves)
    emit({"phase": "train_unfused", **unfused})
    require(flat["max_memory_allocated_gb"] < 80.0,
            f"flat run peak {flat['max_memory_allocated_gb']} GB")

    # ---- where a full-width step's time goes ---------------------------- #
    # each run again, 4 steps (3 local, then a sync), under torch.profiler;
    # step 0 is left out as the warm-up. The profiler slows the host, so
    # the idle share is also given against the unprofiled walls above.
    profiles = {}
    for name, oc, walls in (("per_leaf", oc_leaf, leaf),
                            ("flat", oc_flat, flat)):
        prof = profile_steps(lambda: train_loop(
            cfg, shape, oc, steps=4, n_workers=R, verbose=False,
            device="cuda"))
        require([p["step"] for p in prof] == ["train_step 0 local",
                                              "train_step 1 local",
                                              "train_step 2 local",
                                              "train_step 3 sync"]
                and all(p["launches"] for p in prof),
                f"the profiler saw steps {[p['step'] for p in prof]} and "
                f"launches {[p['launches'] for p in prof]} ({name})")
        for p in prof:
            p["device_idle_share_vs_unprofiled_wall"] = 1.0 - p[
                "device_busy_ms"] / walls[
                "sync_step_ms_median" if p["step"].endswith("sync")
                else "local_step_ms_median"]
        profiles[name] = prof[1:]
    emit({"phase": "profile", "nvidia_smi": smi, "steps": profiles["per_leaf"],
          "flat_steps": profiles["flat"]})
    torch.cuda.empty_cache()

    # ---- slice 4: the synchronous baselines, checkpoints, instrumentation #
    emit({"phase": "baselines", "nvidia_smi": smi, **baselines_phase(
        cfg, shape, small, base, counters, leaf)})
    emit({"phase": "checkpoint", "nvidia_smi": smi,
          **checkpoint_phase(cfg, shape, R)})
    emit({"phase": "instrumented", "nvidia_smi": smi, **instrumented_phase(
        cfg, shape, oc_leaf, counters, leaf, leaf_n, R)})
    torch.cuda.empty_cache()

    # ---- mamba2: reduced card vs CPU, then full-width scoring and serving #
    m2 = dataclasses.replace(m2, ssm_pallas=True,
                             **DEPTH_CUTS["mamba2-370m"])
    params = build_model(m2).init(torch.Generator("cuda").manual_seed(0))
    score, score_n = score_model(m2, params, counters, batch=8, seq=2048,
                                 ssd_calls=m2.n_layers)
    require_launches(score_n, ssd_scan=2 * 3 * m2.n_layers)
    emit({"phase": "score", "nvidia_smi": smi, **score})
    serve, serve_n = serve_mamba2(m2, params, counters, batch=8, prompt=512,
                                  new=32)
    require_launches(serve_n)
    emit({"phase": "serve", "nvidia_smi": smi, **serve})
    del params
    torch.cuda.empty_cache()

    # ---- slice 5: the dense family (qwen2-7b) and Big LSTM serving ----- #
    torch.cuda.empty_cache()
    qwen = dataclasses.replace(get_arch("qwen2-7b"), **DEPTH_CUTS["qwen2-7b"])
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = build_model(qwen).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    qwen_rose = torch.cuda.memory_allocated() - m0
    torch.cuda.empty_cache()
    score, score_dense_n = score_model(qwen, params, counters,
                                       **DENSE_SCORE, ssd_calls=0)
    require_launches(score_dense_n)
    emit({"phase": "score_dense", "nvidia_smi": smi, **score})
    model = build_model(qwen)
    serve, serve_n = serve_model(qwen, params, counters, {
        "one_token_short": lambda p: model.prefill(
            params, {"tokens": p[:, :-1]})[0],
        "queries_rotated_one_ahead": lambda p: rotated_prefill(
            model, params, p)}, **DENSE_DECODE, reported={
        "scores_scaled_2pct": lambda p: model.prefill(
            scaled_queries(params, 1.02), {"tokens": p})[0]})
    require_launches(serve_n)
    emit({"phase": "serve_dense", "nvidia_smi": smi, **serve})
    emit({"phase": "dryrun_card_dense", "nvidia_smi": smi,
          **dryrun_card_dense(params, qwen_rose)})
    del params, model
    torch.cuda.empty_cache()
    # the one-rank prefill's last logits: serve_tp's reference (qwen2-7b
    # cut to TP_SERVE_LAYERS, the same seed; its prompts, the session's at
    # 512, cut to TP_CHECK_PROMPT)
    from repro_torch.data import SyntheticLM
    model = build_model(dataclasses.replace(qwen, n_layers=TP_SERVE_LAYERS))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    with torch.inference_mode():
        tp_want = model.prefill(params, {"tokens": torch.from_numpy(
            SyntheticLM(vocab_size=qwen.vocab_size, seq_len=SERVE_PROMPT,
                        seed=0).worker_batch(0, 0, 8)["tokens"][
                :, :TP_CHECK_PROMPT]).cuda()})[0].float().cpu()
    del params, model
    torch.cuda.empty_cache()
    params = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    model = build_model(cfg)
    serve, serve_n = serve_model(cfg, params, counters, {
        "one_token_short": lambda p: model.prefill(
            params, {"tokens": p[:, :-1]})[0]}, batch=8, prompt=512, new=32)
    require_launches(serve_n)
    emit({"phase": "serve_lstm", "nvidia_smi": smi, **serve})
    del params, model
    free_card()

    slice6_phases(counters, smi)
    hybrid_n = slice7_phases(counters, smi)
    t0 = time.perf_counter()
    two = two_rank_launch(two)
    ranks, ranks_n, fsdp_cli, fsdp_launched = train_ranks_phase(
        root, cfg, shape, smi, leaf, flat, two)
    emit({"phase": "train_ranks", **ranks,
          "seconds": time.perf_counter() - t0})
    fsdp_n = fsdp_phases(cfg, smi, fsdp_cli,
                         ranks["baseline_adaalter"]["steps"], fsdp_launched)
    grid_n = grid_phases(root, cfg, smi, tp_want, list(counters), two,
                         four)
    del two
    by_phase = {"train": leaf_n, "train_flat": flat_n,
                "train_unfused": unfused_n, "score": score_n, **hybrid_n,
                **ranks_n, **fsdp_n, **grid_n}
    emit({"phase": "regress", **regress_phase(root, by_phase)})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "phases_s": phases_s(), "launches": LAUNCHES})

    def entry(name, source, replaces, n, err, timed, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/" + source,
                "replaces": "src/repro/kernels/" + replaces, "launches": n,
                "max_abs_err": err, "ms": timed["ms"],
                "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
                "bound_by": timed.get("bound_by", "bytes"),
                "library_ms": library_ms,
                "launches_by_phase": {k: v[name] for k, v in by_phase.items()
                                      if v[name]}}

    emit({"kernels": [
        entry("adaalter_update", "adaalter_update.cu", "adaalter_update.py:55",
              leaf_n["adaalter_update"],
              max([x["max_abs_err"] for x in upd + tp_parts["update"]
                   + pod_parts["update"]
                   + [u for p in tp_family_parts for u in p["update"]]] + [
                  x["update"] for x in hymba_train["leaves"]]), upd[0]),
        entry("fused_ef", "sync_fused.cu", "sync_fused.py:81",
              leaf_n["fused_ef"],
              max([x["max_abs_err"] for x in ef + fsdp_parts + fsdp_tp_parts
                   + tp_parts["ef"] + pod_parts["ef"]
                   + [e for p in tp_family_parts for e in p["ef"]]] + [
                  max(x["ef_params"], x["ef_b2"])
                  for x in hymba_train["leaves"]]), ef[0]),
        entry("flat_fused_update", "adaalter_update.cu",
              "adaalter_update.py:137", flat_n["flat_fused_update"],
              max([flat_upd["max_abs_err"],
                   hymba_train["flat_update"]["max_abs_err"]]
                  + [x["max_abs_err"] for x in sharded["update"]
                     + sharded["grid_update"] + pod_parts["flat_update"]]),
              flat_upd),
        entry("flat_ef", "sync_fused.cu", "sync_fused.py:164",
              flat_n["flat_ef"], max(x["max_abs_err"] for x in
                                     flat_ef + hymba_train["flat_ef"]
                                     + sharded["ef"] + sharded["grid_ef"]
                                     + pod_parts["flat_ef"]),
              flat_ef[0]),
        entry("quantize_blocks", "quantize.cu", "quantize.py:75",
              unfused_n["quantize_blocks"],
              max(x["max_abs_err"]["quantize"] for x in [quant]
                  + sharded["codes"] + sharded["grid_codes"]),
              quant["quantize"]),
        entry("dequantize_blocks", "quantize.cu", "quantize.py:96",
              unfused_n["dequantize_blocks"],
              max(x["max_abs_err"]["dequantize"] for x in [quant]
                  + sharded["codes"] + sharded["grid_codes"]
                  + [tp_parts["codes"], pod_parts["codes"]]
                  + [p["codes"] for p in tp_family_parts]),
              quant["dequantize"], quant["dequantize"]["library_ms"]),
        # no single PyTorch call computes the SSD chunk scan
        entry("ssd_scan", "ssd_scan.cu", "ssd_scan.py:88",
              score_n["ssd_scan"], max(x["max_abs_err"] for x in
                                       ssd_checks + ssd_hymba + ssd_tp),
              ssd_checks[0]),
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        sys.exit(side_main(*sys.argv[2:4]))
    sys.exit(main())
