#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``chiaswarm_tpu_torch``).

    python3 chip_smoke.py            # on a machine with one NVIDIA GPU

Drives the port's main paths on the card and checks them, phase by phase,
each phase printing one JSON line:

1. probe      — CUDA present; card name and power limit (the raw
                ``nvidia-smi --query-gpu=name,power.limit`` line is printed
                on its own too), torch / CUDA / nvcc versions, the PIL and
                aiohttp versions (the worker's hive client is aiohttp's),
                whether a ``safetensors`` package is installed (the port
                does not use one), the ``tokenizers`` version or null (a
                snapshot's ``tokenizer.json`` needs it) and cv2's version
                (ControlNet's canny mode calls ``cv2.Canny``).
2. build      — builds every CUDA kernel from the checkout's sources, one
                ``nvcc`` per source, all started together, and the host
                artifact codec; prints each kernel's ptxas lines
                (registers, shared memory, spills) and fails on a spill.
3. kernel     — holds kernel B1 (flash attention) against its plain PyTorch
                version at the UNet's shapes for SD1.5 at 512 px in bf16
                (batch 2 for a solo job, 4 for a lone job's lane of 2 rows,
                16 for a lane of 8 rows) and for SDXL at 1024 px (head dim
                64: batch 2 solo, 4 in a lane of 2, 8 in a lane of 4, 1
                for a job without CFG), for instruct-pix2pix's tripled batch
                (batch 3 at head dims 40 and 80) and for the x2 upscaler
                without CFG (batch 1, head dim 64: 16,384, 4,096 and 1,024
                tokens after a 512 px job, 65,536, 16,384 and 4,096 after
                a 1024 px SDXL job; the plain version at 65,536 tokens
                timed over 3 calls), for AudioLDM's UNet at head dim 32 (4
                heads over 2,560 tokens at batch 2 and 1, 1,280 at batch 2)
                (max abs error 4e-3, two bf16 steps
                at the largest outputs, and relative L2 1e-2), for the
                DeepFloyd cascade (IF-II-L's stage 2 at 256 px: 8 heads at
                4,096 tokens and 16 at 1,024, head dim 64, batch 2 and 1;
                the SD x4 upscaler at a 256x256 latent under CFG: 8 heads at
                16,384 and 4,096 tokens, head dim 64, and 8 at 1,024, head
                dim 128), at
                lane_check's and xl_check's fp32 shapes and at ragged fp32
                shapes (2e-4 and
                1e-4, TF32 off); CUDA-event median times of the kernel, the
                plain version and ``scaled_dot_product_attention`` (the
                library yardstick, which the port never calls), with FLOP
                and byte counts and the bound.
4. ring_kernel — holds kernel B2 (one ring hop with carried state) against
                ``ring_flash_hop_plain`` with a non-trivial incoming state,
                on a strided query shard, at the three shapes of the
                sequence-parallel serve path in bf16 (the two at head dims
                40 and 80 on the tensor-core route, the VAE's 512 on the
                sweep), a ragged bf16 shape off the path and a ragged fp32
                one: the normalised output acc / l to B1's bars, m within
                1e-5 and l within a relative 1e-4. Times, FLOPs and bytes
                with the state counted in and out, the bound, and the host
                time to enqueue one hop on an idle card (no single PyTorch
                call computes one hop with carried state, so B2's library
                time is null).
5. fused_kernel — holds kernel B3 (a whole 4-shard ring in one launch)
                against its plain version ``ring_flash_fused_plain`` at the
                ring attentions of the seq slot's serve paths in bf16 (batch
                2 for a solo job, 16 for a lane of 8 rows, 1 for the VAE)
                and a ragged fp32 one (S != L) to B1's bars, and against
                unsharded ``flash_attention_plain`` and the scan drive over
                B2 on the one-card mesh (whether the two agree bit for bit
                is printed). Times of B3, its plain version, the scan
                drive and ``scaled_dot_product_attention`` on the unsharded
                attention (B3's library yardstick), host enqueue times of B3
                and the scan drive, FLOPs, bytes and the bound.
6. check      — the full-width SD1.5 UNet in float32 on a small latent, once
                with the spatial self-attention through B1 and once through
                the plain path: relative L2 difference within 1e-4, and B1
                launched 5 times (the five 1024-token self-attentions); then
                the same UNet in bf16, the serve dtype, at 64x64 latents
                (4096 tokens), B1's tensor-core route against the plain
                ``xla`` route: within the repo's bf16 parity bar, relative
                L2 3e-2, with 10 B1 launches (5 at 4096 tokens, 5 at 1024).
6c. xl_check — the full-width SDXL UNet (2.57 B parameters) in bf16 at a
                128x128 latent with its added conditioning (time ids and
                pooled text): one eval through B1 (70 launches: 10 at 4096
                tokens, 60 at 1024, head dim 64) against the plain route,
                relative L2 3e-2; then the same weights in float32 at a
                64x64 latent, TF32 off: 1e-4, 10 launches.
7. ring_check — the same UNet under a ``seq = 4`` mesh against the
                single-device plain route: relative L2 within 1e-4, with
                exactly 5 B3 launches (the five 1024-token self-attentions)
                and, under the scan drive, 80 B2 launches (x 4 shards x 4
                hops); the full-width VAE decode in float32 at a 64x64
                latent, ring against local: within 1e-4, 1 B3 launch and 16
                B2 launches at head dim 512; then the UNet in bf16 at 64x64
                latents under the scan drive (B2's tensor-core route at both
                of its serve shapes) against the single-device plain route:
                relative L2 3e-2, exactly 160 B2 launches and no other
                kernel.
6b. lane_check — the same UNet in float32 on a 32x32 latent: ONE lane step
                (``DiffusionPipeline.stepper_step``) over 4 rows at different
                ladder positions (step counts 20, 12 and 7, guidance 7.5, 5.0
                and 9.0, one inactive row) against each row's solo step (a
                batch-1 CFG UNet call and ``sampler_step``), for
                DPM-Solver++(2M) and Euler: relative L2 1e-4 on x and the
                multistep history, the inactive row bit for bit, 5 B1
                launches for the lane step, all at the fp32 shape phase 3
                holds.
8. serve      — SD1.5 at its published widths, random bf16 weights from a
                seed, three 512x512 txt2img jobs (20 steps, guidance 7.5,
                default scheduler) through the port's executor
                ``synchronous_do_work`` on the solo path
                (``CHIASWARM_STEPPER=0`` for this phase and the next two).
                Every envelope must carry no error and a 512x512 PNG, and
                B1's launch count over the three jobs must be jobs x steps x
                10 (5 self-attentions at 4096 tokens and 5 at 1024 per UNet
                evaluation, CFG batched).
9. seq_serve  — the same three jobs on a slot whose mesh has ``seq = 4``
                over ``cuda:0`` named four times: every envelope error-free
                with a 512x512 PNG, B3 launched jobs x (steps x 10 + 1)
                times, B1 and B2 never. The uint8 difference from the serve
                phase's image of the same seed is printed as information.
10. seq_serve_scan — the same jobs under ``CHIASWARM_RING_FLASH=scan`` on a
                ``seq = 4`` slot (``cuda:0..3`` when four cards are visible,
                else ``cuda:0`` named four times, and the rotation copies
                stay on the card): B2 launched jobs x (steps x 160 + 16)
                times, B1 and B3 never.
11. lane_serve — the serve jobs again, one after another, through the
                continuous-batching lanes (the default engine): each job a
                lane's (a ``stepper`` stamp, no fallback to the per-job
                path), B1 launched 10 times per lane step; the uint8
                difference from the serve phase's image of each seed is
                printed as information.
12. lane_burst — eight jobs at once through ``synchronous_do_work_batch``
                on a lane pinned at 8 rows (steps 20 and 12, guidance 7.5
                and 5.0 alternating) and a ninth through
                ``synchronous_do_work`` from a second thread once the lane
                has stepped 5 times: it splices in mid-flight when the
                12-step rows retire. Every job on one lane, the ninth
                admitted at a step >= 1, B1 launched 10 times per lane step
                and fewer lane steps than half the jobs' summed steps; job
                11 alone in a lane of the same width within one uint8 level
                of its burst image. Images/s, peak memory, resizes and the
                active and padded row steps are printed.
13. lane_seq_serve — four of the burst jobs through the lanes of the
                one-card ``seq = 4`` slot, pinned at 8 rows: B3 launched 10
                times per lane step and once per decode, B1 and B2 never.
14. solo_pair — seed 1 with ``num_images_per_prompt=2`` on the solo path
                (a CFG batch of 4 rows, a lane of 2's UNet batch) and
                through a lane pinned at 2 rows (the same UNet batch, text
                batch and noise): bit for bit, the lane's per-row step held
                to the solo step on the card. The solo pair's first image is
                printed beside the lone job's lane image and the solo
                one-image render.
14b. checkpoint_serve — SD1.5 from disk: the serve phases' seed-0 weights
                written as a diffusers-layout directory of float32
                safetensors (the published snapshot's dtype; bf16 weights
                round-trip it exactly) through the port's own writer, with
                a synthetic 49,408-entry CLIP vocab and its 48,894 merges
                made here, under ``build/chip_smoke_root`` (the run's
                settings root, removed when the run ends; its bytes and the
                free space are printed), synced and advised out of the page
                cache. The files are read once with ``O_DIRECT`` (the disk's
                read time and rate) and the share of their pages the page
                cache still holds is printed (``mincore``); then a
                ``ModelRegistry`` with no random fallback loads it: load
                seconds split into file read and device copy, the load's
                peak ``max_memory_allocated`` against ``param_bytes`` and
                ``estimate_family_bytes("sd15")``, every parameter
                ``torch.equal`` to its source. A second registry loads it
                again while serve's seed-1 job steps in the source model's
                lane on another thread: every parameter equal to its source,
                the lane's image bit for bit lane_serve's, the lane stepping
                during the load. Seeds 1-3 one after another in the lanes,
                each image bit for bit the source modules' with the loaded
                tokenizer swapped in (the same lane composition), B1 = 10 x
                lane steps; each job's spans (text encode, lane wait,
                decode, PNG) beside lane_serve's.
14c. residency_churn — two catalog names over that checkpoint (the second a
                directory of links) under a ledger that holds one model
                (1.5x the measured footprint): A in a lane; B's load evicts
                A and retires A's lane at drain, ``memory_allocated`` back
                within one model (plus 5%) of the level before A, the
                ledger's peak of resident + reserved bytes at most budget +
                one model; A's reload renders its first image bit for bit.
                A budget below one model degrades A to load-per-job (no
                lane, ``residency: per_job``, bit for bit the solo path's
                image); a hard limit below the footprint gives a non-fatal
                ``model_unavailable`` envelope. Prints the evict + load and
                reload seconds and the ledger's ``snapshot()``.
15. worker_serve — the port's hive worker (``node/worker.py``:
                ``Worker.run()``) against a hive served from a thread of
                this script (standard-library ``http.server``: ``/api/work``,
                ``/api/results``, ``/api/models``), on the lanes: serve's
                seed-1 job alone in a fresh lane (bit for bit lane_serve's
                image, a stepper stamp), then twice more in the warm lane,
                each after the same job through ``synchronous_do_work``
                (the worker's cost over the executor's, image for image);
                lane_burst's nine jobs at 8 rows pinned (seeds 11-18 from
                the first poll that returns work, seed 19 from a later one
                once the lane has stepped 5 times), each bit for bit the
                image of a replay that admits the same jobs into the same
                lane slots at the same lane steps (the difference from
                lane_burst's image of each seed is printed: lane_burst fills
                other slots, and cuDNN's convolutions are not
                batch-position invariant, ``tools/torch_batch_position.py``);
                one 503 on an upload (one retry, the result arrives once),
                checkpoint_serve's seed-1 job through a worker whose
                registry loads the checkpoint from disk (bit for bit
                checkpoint_serve's image), then
                ``python -m chiaswarm_tpu_torch.node.worker`` as a
                child process: its registry has no checkpoint, so it
                uploads a non-fatal ``model_unavailable`` envelope, and on
                SIGTERM it drains and exits with 0. B1 = 10 x lane steps.
                Prints each job's seconds (poll receipt to settled upload,
                from the worker's traces and ``chiaswarm_job_seconds``) with
                its spans (format, text encode, lane wait, decode, PNG and
                base64, upload), the worker's host seconds (job seconds
                minus ``generation_s``), the burst's images/s from the first
                poll that returned work to the last upload beside
                lane_burst's, lane steps and occupancy.
15b. xl_serve — SDXL at its published widths (3.47 B parameters: UNet
                and VAE in bf16, both text towers in float32, random from
                seed 0, drawn on the card once and reused by every SDXL
                phase; both towers on the synthetic CLIP vocab), serve's
                three jobs at 1024x1024 on the solo path: error-free
                envelopes with 1024x1024 PNGs, B1 exactly 1,400 times a job
                (20 steps x 70) and no other kernel. Prints the weights'
                init seconds, job seconds, ``generation_s`` and the peak of
                ``max_memory_allocated``.
15c. xl_lane_serve — the same three jobs one by one through the lanes (a
                lane of 2 rows, UNet batch 4): B1 = 70 x lane steps; each
                image's uint8 difference from xl_serve's is printed (another
                batch composition). Then a guidance-1.0 job: no lane takes
                it, the solo path serves it without CFG at B1 batch 1.
15d. xl_lane_burst — four SDXL jobs (seeds 11-14) at once at a lane width
                pinned to 4 (UNet batch 8): one lane, B1 = 70 x lane steps,
                fewer lane steps than half the summed steps. Prints lane
                steps, images/s beside xl_serve's after its first job,
                occupancy and peak memory.
15e. xl_worker_checkpoint — the drawn SDXL weights written as a
                diffusers-layout directory (``unet/``, ``vae/``,
                ``text_encoder/``, ``text_encoder_2/``, ``tokenizer/``),
                each tensor at its serving dtype (~8.6 GB), under the run's
                settings root as ``stabilityai__stable-diffusion-xl-base-
                1.0``; a registry with no random fallback loads it (load
                seconds split into read, copy and the rest, the peak against
                ``param_bytes``, every tensor ``torch.equal`` to its source)
                and the worker serves seed 1 for that name against a hive in
                this script: bit for bit xl_lane_serve's seed 1. The
                directory is removed at the end of the phase.
15f. img2img_serve — after residency_churn (so before worker_serve): SD1.5
                img2img at 512 px, 20 steps, strengths 0.75, 0.5 and 0.3
                (start indices 5, 10 and 14), each init image made from a
                seed and fetched over HTTP from a hive of this script
                through the job's ``start_image_uri``; solo, then one by
                one in lanes: B1 exactly 10 x UNet evals (310) and no other
                kernel in each; then seed 31 with two images solo and in a
                lane pinned at 2 rows, bit for bit. Prints each job's
                seconds, ``generation_s``, and its encode's device ms
                (CUDA events around ``encode_init_image``) and share.
15g. inpaint_serve — two inpaint jobs (a fetched rectangular
                ``mask_image_uri``), solo then in lanes: B1 = 10 x 20 a job;
                each job's final latents equal its encoded init latents
                exactly where the latent mask keeps them; the kept pixels'
                mean uint8 error against the source at most 1.5x the
                source's own VAE round-trip error + 2 (both printed).
15h. seq_img2img — the strength-0.75 job on the one-card ``seq = 4`` slot:
                B3 exactly 10 x 15 + 1, no other kernel (the encode does
                not ring).
15i. xl_img2img_serve — one SDXL img2img job at 1024 px (strength 0.75),
                solo then in a lane: B1 exactly 70 x 15.
15j. encode_check — SD1.5's VAE encoder (bf16) against its float32 copy at
                512 px: relative L2 of the latent mean within 3e-2, no
                kernel; the encode's device ms alone (inputs on the
                card), the whole encode_init_image call's event ms (host
                work inside) and its peak memory, at 512 px and at 1024 px
                (SDXL's VAE). worker_serve gains an img2img
                and an inpaint job fetched by URI (bit for bit the lane
                images of 15f and 15g) and an init image past the 3 MiB
                cap (a non-fatal ``bad_asset`` envelope).
15k. guard_lane — the gray-failure guard (after worker_serve): serve's
                seed-1 txt2img job and an inpaint job (seed 41, fetched from
                a hive of this script) in a lane pinned at 2 rows, both
                admitted at its first step, through
                ``synchronous_do_work_batch``: once uninterrupted, once with
                lane step 12 wedged by ``CHIASWARM_CHAOS_WEDGE_STEP="12:6"``
                (a 6 s host sleep inside the step's armed window; hang floor
                1 s, ceiling 20 s). The watchdog condemns the lane, both jobs
                resume at step 8 (the default checkpoint cadence) in one
                fresh lane, each image bit for bit its uninterrupted run, the
                inpaint job's kept latents exactly its encoded ones, B1 = 10 x
                lane step dispatches (the condemned lane's included). Prints
                the counters, the hang budget and the seconds from the
                condemnation to the first resumed dispatch.
15l. guard_nan — seeds 1 and 2 in a lane of 2 through the worker, row 1
                poisoned after lane step 5 (``CHIASWARM_CHAOS_NAN_STEP="5:1"``):
                the step-8 checkpoint's finite check retires seed 2's job
                alone, its envelope a non-fatal ``invalid_output`` and the
                worker's ``chiaswarm_guard_invalid_outputs_total`` 1; seed
                1's image bit for bit its unpoisoned twin.
15m. guard_solo — the solo path under the watchdog through the worker:
                serve's seed 1 (its key warm first), its diffusion callback
                wrapped once in a sleep 3 s past its budget (factor 2):
                ``StepHung``, classified ``transient``, one retry, the
                image bit for bit the serve phase's.
15n. guard_worker — the healing ladder (thresholds 1, 2, 3; hang ceiling
                3 s): seeds 1 and 2 in a lane of 2 whose first dispatch
                wedges, re-armed once, so the fresh lane wedges too; the
                rungs apply as cache_flush, device_quarantine (declined: one
                card), restart; ``run()`` returns by itself with exit code 73
                after a graceful drain, each job settled once without error
                (on the per-job path). guard_child: ``python -m
                chiaswarm_tpu_torch.node.worker`` on the checkpoint of 14b
                (thresholds 1, 2, 2; lane step 3 wedged) exits with 73, its
                job settled once without error.
15o. guard_cost — lane_burst's nine jobs as one burst at 8 rows, four
                times (guard off, on, on, off): images/s of each, the
                checkpoints a run and the mean ms of one checkpoint boundary
                (the copy to the host, which waits for the queued steps, the
                finite check and the generator states), the card; images
                bit for bit across the runs, times not gated.
15p. guard_xl — guard_lane for SDXL at 1024 px (after the SDXL phases), two
                txt2img jobs (seeds 1, 2): both resume at step 8 bit for
                bit, their pooled text encoded again; B1 = 70 x dispatches.
15q. safety_check — the NSFW safety checker at its published widths
                (ViT-L/14: 1024 hidden, 24 layers, 16 heads, 4096
                intermediate, patch 14 at 224, projection 768; 17 concept
                and 3 special-care embeddings), random from a seed, written
                as the standalone checker directory of the run's settings
                root and loaded on the card and on the CPU in float32: two
                512 px pictures and one at 1024 px, the card's embeddings
                within 2e-4 (relative to the largest) of the CPU's, the
                concept thresholds set from the CPU's so the first flags and
                the second does not, the flags equal. Prints the checker's
                bytes and its ms per image at 512 and 1024 px (host clock and
                CUDA events around the whole check, preprocessing included;
                the preprocessing's host ms; the tower's device ms alone).
15r. safety_serve — that checker installed, its thresholds set from the
                CPU embeddings of serve's seed-1 and seed-2 images (seed 1
                flags): the two jobs solo (bit for bit serve's), the pair
                admitted together into one adaptive lane (it grows to 4
                rows), and SDXL's seed 1 at
                1024 px: each envelope's ``nsfw``/``nsfw_flags`` equal the
                CPU checker's flags on its decoded image, the solo pair
                flags seed 1 alone; B1 = 10 (70) x evals. The directory is
                removed after, so the other phases run without a checker.
15s. controlnet_serve — a ControlNet at SD1.5's published widths (bf16,
                its zero convs seeded) written as a diffusers-layout
                directory and loaded through the registry with no random
                fallback (tensors equal); Canny conditioning images fetched
                from this script's hive. Solo: seeds 1 and 2 as txt2img,
                seed 1 as a control job at scales 1.0, 0.5 and 0 on one map
                and seed 2 at 0.5 on another (1024 px, resized): the scale-0
                image bit for bit the txt2img image, B1 = 14 x evals (10 for
                txt2img); the txt2img pair, then the control pair, each
                admitted together into one adaptive lane of the same width:
                the control pair's uint8 difference from its solo images at
                most the txt2img pair's plus a small margin (a row given the
                other's hint or scale strays by tens of levels); a two-image
                job solo and in a lane pinned at 2 rows bit for bit (the
                same composition); through the worker, a job with an annotated
                ``start_image_uri`` and one with ``preprocess: true, type:
                canny`` (its ``preprocessed_input`` echo cv2's edges
                exactly). Every envelope error-free with the ``controlnet``
                stamp. Prints ``generation_s`` of the control jobs against
                txt2img and the bundle's bytes in the ledger.
15t. xl_controlnet_serve — an SDXL ControlNet (random, zero convs seeded):
                seed 1 at 1024 px as txt2img and as a control job, solo: B1
                = 70 x 20 and 104 x 20. Prints both ``generation_s``.
15t2. preprocess_check — the six learned ControlNet detectors at their
                published widths (HED, M-LSD large, lineart with 3 blocks,
                the CMU body-pose net, DPT-Large at 384 px, UperNet-ConvNeXt-
                small at 512 px; 496 M float32 parameters, ~2.0 GB), seeded
                on the CPU, written under ``<settings root>/models/<name>``
                in their published files' layouts and loaded on the card
                through ``from_checkpoint`` (tensors equal, the files' unused
                keys dropped). On one 512x512 picture: each network's output
                on the card against the CPU within ``tf32_bar`` of its conv
                depth (cuDNN's TF32 on), the continuous maps (HED, lineart,
                DPT) 99% within one level of the CPU's, the threshold maps'
                agreement and non-zero share printed; no kernel of the port.
                Prints load seconds, bytes, the network's device ms and the
                host ms of preparing and post-processing.
15t3. preprocess_serve — ControlNet jobs with ``preprocess: true`` at 512
                px (4 steps) through ``synchronous_do_work``, their picture
                fetched from this script's hive: with the detector
                directories aside, the eight stand-in modes and openpose's
                fatal envelope naming its directory; with them back, the
                nine learned modes solo (each detector loaded on the card)
                and a depth and a seg job in one lane. Every envelope
                error-free with the ``controlnet`` stamp, its
                ``preprocessed_input`` echo exactly the port's own map of
                the picture, B1 = 14 x evals and no other kernel. Prints the
                preprocess seconds against ``generation_s`` a mode.
15u. pix2pix_serve — instruct-pix2pix at its published widths (SD1.5's
                UNet with an 8-channel ``conv_in``, bf16, random from seed
                0) written as a diffusers-layout directory under
                ``timbrooks__instruct-pix2pix`` and loaded with no random
                fallback (tensors equal); one tripled-batch UNet eval
                through B1 against its float32 copy on the plain route
                (relative L2 3e-2, 10 launches); two jobs (strengths 0.3
                and 0.6: image guidance 1.5 and 3.0) through the worker,
                their pictures fetched from this script's hive, with the
                lanes on: PNGs of the input's size, ``mode`` and
                ``image_guidance_scale`` stamped, no lane, B1 = 10 x 20 a
                job at batch 3; the first job again, bit for bit.
15v. upscale_serve — the x2 upscaler at the JAX family's widths (bf16,
                random from seed 0) written under
                ``stabilityai__sd-x2-latent-upscaler`` and loaded (tensors
                equal); serve's seed 1 with ``parameters.upscale`` through
                ``synchronous_do_work`` with the lanes on and through the
                worker: a 1024x1024 PNG, the four upscaler keys, no lane,
                B1 = 10 x 20 + 16 x 20, the image bit for bit a direct
                upscaler call on the job's own 512 px image and the
                worker's image bit for bit the executor's. Prints
                ``generation_s``, the pass's seconds and event ms, B1's
                share of them (its launches by shape times the kernel
                phase's ms) and the peak memory.
15w. xl_upscale_serve — SDXL's seed 1 at 1024 px with ``parameters.
                upscale``: a 2048x2048 PNG decoded in 25 tiles, B1 = 70 x
                20 + 16 x 20, bit for bit a direct call; a latent of one
                tile decodes bit for bit like the untiled decode. Prints
                upscale_serve's numbers and the tiles.
15x. adapters_serve — a seeded rank-4 LoRA on every transformer's
                attention projections of SD1.5 (attn-procs and peft names)
                and a two-vector inversion of ``<chip-smoke>``: the two
                files merge to the same UNet bit for bit; scale 0 renders
                the base image bit for bit; scales 1.0 and 0.5 are ledger
                entries of their own (bytes printed); the inversion keeps a
                prompt without its token bit for bit and changes one with
                it; a two-image LoRA job solo and in a lane pinned at 2 rows
                bit for bit; B1 = 10 x 20 a LoRA job.
15y. stitch_serve — four PNGs (512, 768, 1024 and 256 px) served by this
                script's hive as earlier results, one ``stitch`` job through
                the worker: a 288x288 JPEG, four ``image_map`` rects whose
                hrefs are the four URIs, byte for byte a CPU call of
                ``stitch_callback`` on the same pictures; no kernel.
15z. caption_serve — BLIP-base with its question tower at the published
                widths (ViT-B/16 at 384 px, 12 x 768 BERT towers), random
                from seed 0, written as a transformers directory with a
                synthetic 30,524-entry ``vocab.txt`` and loaded with no
                random fallback (tensors equal); a caption, a conditioned
                caption and a VQA job through the worker: each text a direct
                call's; the first decode step's logits within 2e-3 of a CPU
                load of the same directory and the ids the CPU's up to the
                first step whose top-two gap is below that bar (printed); no
                kernel. Prints job seconds and the vision encode's device ms.
15aa. audio_serve — AudioLDM at JAX's widths (UNet and VAE bf16, CLAP and
                the vocoder float32), random from seed 0, written as a
                diffusers directory with a synthetic byte-level vocab and
                loaded with no random fallback (tensors equal); 10 s and 5 s
                jobs at guidance 2.5 and a 10 s job at 1.0 through the
                worker, 20 steps: B1 exactly 5 x UNet evals at each job's
                head-dim-32 shape and no other kernel; ``audio/wav``
                (``audio/mpeg`` with ffmpeg) of 160,000 / 80,000 samples; the
                first job again, the same bytes; its waveform within 3e-2
                relative L2 of the plain route; the vocoder on the card
                (cuDNN's default TF32) within that bar of its CPU run.
                Prints job seconds, ``generation_s``, device ms by stage,
                B1's share and the peak memory.
15ab. tts_serve — Bark at its published widths (three 24 x 1,024 GPTs in
                bf16, vocabularies 129,600 / 12,096 / 1,056, the 8-codebook
                EnCodec at 24 kHz in float32; 1.10 B parameters), random
                from seed 0 through the registry's ``allow_random``
                fallback; a 4 s job at temperature 0.7, one with a
                ``history`` preset of Bark's shapes and one naming a preset
                by a string through the worker, then the first again: WAV
                (MP3 with ffmpeg) of ``frames x 320`` samples at 24 kHz, the
                same bytes twice, the named preset JAX's fatal envelope, no
                kernel launched; the semantic stage at ``top_k = 1`` against
                a float32 CPU forward of the same weights over the ids the
                card fed back (first-step logits within 0.08, every id the
                CPU's where its top-two gap is at least that); the codec
                within 1e-2 relative L2 of its CPU run. Prints job seconds,
                ``generation_s``, the served jobs' device ms by stage,
                decode tokens/s, the busy share and launches per decode
                step (``tools/torch_serve_profile.py``'s ``tts_profile``)
                and the peak memory.
15ac. txt2vid_serve — ModelScope at its published widths (the UNet3D and
                VAE bf16, the 23-layer CLIP-H tower float32; 1.84 B
                parameters), random from seed 0 through the registry's
                fallback; a txt2vid job at the defaults (256 px, 25 frames
                bucketed to 32, 25 steps, guidance 9.0), the same job again
                and one at guidance 1.0 through the worker: ``video/mp4`` of
                25 frames of 256x256 (read back with OpenCV), a JPEG
                thumbnail, JAX's config keys; the repeat's frames bit for
                bit; B1 exactly 5 x evals at (64|32,1024,1024,5,64) and no
                other kernel; one eval through B1 within 3e-2 relative L2 of
                the plain route and one at 2 frames within 5e-2 of a float32
                CPU eval. Prints job seconds, ``generation_s``,
                ``frames_per_sec``, device ms by stage (text encode,
                denoise, decode), the container's host seconds, B1's ms and
                share, launches an eval, the busy share and top kernels
                (``tools/torch_serve_profile.py``'s ``video_profile``) and
                the peak memory.
15ad. img2vid_serve — SVD at its published widths (the spatio-temporal UNet
                and temporal VAE bf16, ViT-H/14 float32; 2.25 B
                parameters), random from seed 0; a job from a start image
                on this script's hive at the defaults (512 px, 14 frames
                bucketed to 16, guidance 1.0 -> 3.0, ``IMG2VID_STEPS``), the
                same job again and the same seed on another image: 14
                frames of 512x512, the repeat bit for bit, the other image
                other frames; B1 exactly 5 x evals at (32,4096,4096,5,64)
                and (32,1024,1024,10,64); the eval gates. Prints
                txt2vid_serve's numbers.
15ae. vid2vid_serve — the run's SD1.5 on a 12-frame 512x910 mp4v clip
                served over HTTP, strength 0.6, 20 steps (chunks of 8 and 4
                frames, 12 evals each), and the same job again: 12 frames
                of 512x910, the repeat bit for bit; B1 exactly 5 x evals at
                (16|8,7680,7680,8,40) and (16|8,1920,1920,8,80); each
                frame's init latent its own encode (none equal); a
                one-frame stack the one-image img2img path bit for bit.
                Prints job seconds, the encodes' and generate calls'
                device ms, B1's ms and share and the peak memory.
15af. cascade_check — the run's models released from the registry's
                ledger first (``release_models``: a squeeze to a zero
                budget); the DeepFloyd cascade (T5-XXL, IF-I-XL's base,
                IF-II-L's super-resolution; ~6.2 B parameters) and the SD x4
                upscaler (~0.9 B) drawn at their published widths through
                the registry's random fallback. One bf16 eval of the stage-2
                UNet at a 256 px input and of the x4 UNet at a 256x256
                latent with its class label, each through B1 (11 and 16
                launches) against the plain route, relative L2 3e-2; one
                prompt through T5-XXL in bf16 (finite embeddings); one x4
                VAE decode at a 256x256 latent (the mid block's 65,536-token
                attention on the plain path, in blocks of queries): its ms
                and peak memory over the level before.
15ag. cascade_serve — three DeepFloyd jobs through ``synchronous_do_work``
                (the hive's defaults: 50 base and 30 super-resolution steps
                at guidance 7.0, the x4 pass at 75 steps and 9.0; the same
                job again; a guidance-1.0 job at 20 and 10 steps): each a
                1024x1024 PNG with the cascade's config (three stages, the
                x4 keys), the repeat bit for bit, B1 exactly by shape from
                the configs (1,530 launches at the defaults), B2 and B3
                never. Prints each job's seconds, ``generation_s``, device
                ms by stage (T5, stage 1, stage 2, the x4's text, denoise
                and decode), B1's ms and share, the peak memory, and the
                default job under ``tools/torch_serve_profile.py``'s
                ``cascade_profile`` (busy share, B1's share, top kernels).
16. shapes_held — every shape at which a phase from 8 on launched a kernel
                is one its kernel phase (3-5) held against the plain
                version; each phase's launches by shape.
17. kernels   — one line ``{"kernels": [...]}``: each port kernel, the TPU
                kernel it replaces, its designs (``wgmma+cp.async`` for the
                tensor-core route of B1, B2 and B3 — bf16 and fp16 at head
                dims up to 160 — ``sweep`` for the CUDA-core sweep of fp32
                and head dim 512), its launches on its solo serve phase
                (by shape too), and its numbers from its kernel phase
                averaged over those launches (per-shape numbers, each with
                its design and its factor against the library call, under
                ``shapes``); B1 also under ``lane_serve``, ``lane_burst``,
                ``checkpoint_serve``, ``residency_churn``,
                ``worker_serve``, the four SDXL serve phases, the image
                phases, the guard phases, the safety and ControlNet
                phases, the pix2pix, upscale and adapter phases,
                audio_serve (head dim 32), the three video phases and
                cascade_serve (head dim 128 among its shapes), and B3
                under ``lane_seq_serve``
                and
                ``seq_img2img``, with
                their launches there and their numbers over those
                launches.

Before the kernels line, ``script_wall`` prints the run's seconds so far.
The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises,
so the script exits non-zero without that line — also when CUDA is absent
or the package is not next to this file.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SERVE_JOBS = 3
SERVE_STEPS = 20
B1_LAUNCHES_PER_UNET_EVAL = 10
# SDXL at 1024 px: 4 + 6 self-attentions at 4096 tokens (two depth-2
# transformers down, three up), 20 + 10 + 30 at 1024 (depth 10: two down,
# the mid block, three up)
B1_LAUNCHES_PER_XL_EVAL = 70
RING_SHARDS = 4
# ten self-attentions per UNet eval ring (five at 4096 tokens, five at
# 1024), each 4 shards x 4 hops; the VAE mid block rings once per job
B2_LAUNCHES_PER_UNET_EVAL = 10 * RING_SHARDS * RING_SHARDS
B2_LAUNCHES_PER_DECODE = RING_SHARDS * RING_SHARDS
# B3 runs each of those ring attentions in one launch
B3_LAUNCHES_PER_UNET_EVAL = 10
B3_LAUNCHES_PER_DECODE = 1


def design(dtype_name: str, d: int) -> str:
    """The route a launch of B1, B2 or B3 takes: bf16 and fp16 at head dims
    up to 160 run on the tensor cores (wgmma, K/V by cp.async); fp32 and the
    VAE's head dim 512 run the CUDA-core sweep."""
    tensor_cores = dtype_name in ("bfloat16", "float16") and d <= 160
    return "wgmma+cp.async" if tensor_cores else "sweep"


def vs_library(ms: float, library_ms: float | None) -> float | None:
    """The kernel's time as a multiple of the library call's."""
    return None if library_ms is None else ms / library_ms


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def probe():
    if not (ROOT / "chiaswarm_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo: "
                         "chiaswarm_tpu_torch/ is not beside it")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no GPU to run on")
    from chiaswarm_tpu_torch.ops.kernels import nvcc_path

    smi = nvidia_smi_line()
    print(smi, flush=True)
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    try:
        import PIL

        pil = PIL.__version__
    except ImportError:
        pil = None
    try:  # the worker's hive client (node/hive.py)
        import aiohttp

        aiohttp_version = aiohttp.__version__
    except ImportError:
        aiohttp_version = None
    try:  # the port reads and writes safetensors without this package
        import safetensors

        safetensors_version = safetensors.__version__
    except ImportError:
        safetensors_version = None
    try:  # a snapshot's tokenizer.json (the DeepFloyd cascade's T5)
        import tokenizers

        tokenizers_version = tokenizers.__version__
    except ImportError:
        tokenizers_version = None
    try:  # ControlNet's canny preprocessing and the video workloads
        import cv2

        cv2_version = cv2.__version__
        cv2_video = cv2_video_io(cv2)
    except ImportError:
        cv2_version = cv2_video = None
    emit("probe", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1],
         python=sys.version.split()[0], pil=pil, aiohttp=aiohttp_version,
         safetensors=safetensors_version, tokenizers=tokenizers_version,
         cv2=cv2_version, cv2_video=cv2_video)
    return torch


def cv2_video_io(cv2) -> dict:
    """OpenCV's video I/O backends and whether its writer opens the two
    containers the video workloads encode (mp4v in .mp4, VP90 in .webm)."""
    import tempfile

    registry = cv2.videoio_registry
    out = {"backends": [registry.getBackendName(b)
                        for b in registry.getBackends()],
           "writers": [registry.getBackendName(b)
                       for b in registry.getWriterBackends()]}
    with tempfile.TemporaryDirectory() as tmp:
        for suffix, fourcc in ((".mp4", "mp4v"), (".webm", "VP90")):
            writer = cv2.VideoWriter(str(Path(tmp) / f"probe{suffix}"),
                                     cv2.VideoWriter_fourcc(*fourcc), 8.0,
                                     (64, 64))
            out[fourcc] = bool(writer.isOpened())
            writer.release()
    return out


def build() -> None:
    from chiaswarm_tpu_torch import native
    from chiaswarm_tpu_torch.ops.kernels import KERNELS, build_all

    t0 = time.perf_counter()
    libs = build_all()
    kernel_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    if native.CODEC.load() is None:
        raise RuntimeError("the artifact codec did not build (g++ and zlib)")
    codec_s = time.perf_counter() - t1
    ptxas = {name: [line.split("ptxas info    : ")[-1].strip()
                    for line in k.build_log.splitlines()
                    if "Used" in line or "spill" in line]
             for name, k in KERNELS.items()}
    spills = {name: sum(int(n) for line in k.build_log.splitlines()
                        for n in re.findall(r"(\d+) bytes spill", line))
              for name, k in KERNELS.items()}
    emit("build", kernels={n: str(p.relative_to(ROOT)) for n, p in libs.items()},
         kernel_build_s=round(kernel_s, 3),
         nvcc_s={name: round(k.build_s, 3) for name, k in KERNELS.items()},
         codec_build_s=round(codec_s, 3),
         spill_bytes=spills, ptxas=ptxas)
    if any(spills.values()):
        raise AssertionError(f"a kernel spills registers: {spills}")


# the card sleeps this long before each timed call (about 1 ms at the
# H100's clock), so the host has enqueued the call before the card reaches
# it and the events time the device alone, not the host's launch cost
SLEEP_CYCLES = 2_000_000


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in ms, after ``warmup`` calls, each
    timed call queued behind a device sleep of :data:`SLEEP_CYCLES`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median host time in ms to enqueue ``fn`` on an idle card: the Python
    and launch cost alone, the device's own time excluded."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flops: int, nbytes: int, dtype) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of ``dtype`` and the bytes over the memory rate."""
    op_ms = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes"}


def attention_work(b: int, l: int, s: int, h: int, d: int, dtype) -> dict:
    """FLOPs and bytes one forward attention needs: 2·L·S·D multiply-adds
    for QK^T and again for PV per (batch, head); each input read once and
    the output written once."""
    elem = dtype.itemsize
    return bound(4 * b * h * l * s * d,
                 (2 * b * l * h * d + 2 * b * s * h * d) * elem, dtype)


# With randn q/k/v the outputs have a standard deviation of about
# sqrt(e / S): 0.026 at S = 4096 and 0.05 at S = 1024, peaks near 0.25. Both
# sides round fp32 sums to bf16, and the tensor-core route rounds p to bf16
# for P·V (about 2e-3 relative L2 against the fp32 p of the plain version,
# tests/test_torch_flash.py), so they differ by a step or two (2e-3 at
# 0.25); a kernel off by a few percent everywhere (a wrong scale, a skipped
# KV tile) fails the relative L2 bar.
KERNEL_SHAPES = [
    # (B, L, S, H, D, dtype, max abs error, relative L2, the phases that
    # launch it: the solo serve path (one job, CFG doubles the batch), a lone
    # job's lane of 2 rows in lane_serve (its adaptive lane may narrow to
    # one row, batch 2) and preprocess_serve's detector pair, two jobs admitted together, whose adaptive lane
    # grows to 4 rows, in safety_serve and controlnet_serve, a lane of 8
    # rows in lane_burst, and lane_check's fp32 lane step over 4 rows at a
    # 32x32 latent)
    (2, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("serve",)),
    (2, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("serve",)),
    (4, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2,
     ("lane_serve", "preprocess_serve")),
    (4, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2,
     ("lane_serve", "preprocess_serve")),
    (8, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2,
     ("safety_serve", "controlnet_serve")),
    (8, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2,
     ("safety_serve", "controlnet_serve")),
    (16, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("lane_burst",)),
    (16, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("lane_burst",)),
    (8, 1024, 1024, 8, 40, "float32", 2e-4, 1e-4, ("lane_check",)),
    # SDXL at 1024 px, head dim 64: 10 heads at 4096 tokens and 20 at 1024,
    # a solo job (CFG, batch 2), a lone job in a lane of 2 rows (batch 4; the
    # worker's checkpoint job too), a lane pinned at 4 rows (batch 8), the
    # no-CFG solo job at guidance 1.0 (batch 1), and xl_check's fp32 UNet at
    # a 64x64 latent (its 1024-token level has 10 heads)
    (2, 4096, 4096, 10, 64, "bfloat16", 4e-3, 1e-2, ("xl_serve",)),
    (2, 1024, 1024, 20, 64, "bfloat16", 4e-3, 1e-2, ("xl_serve",)),
    (4, 4096, 4096, 10, 64, "bfloat16", 4e-3, 1e-2,
     ("xl_lane_serve", "xl_worker_checkpoint")),
    (4, 1024, 1024, 20, 64, "bfloat16", 4e-3, 1e-2,
     ("xl_lane_serve", "xl_worker_checkpoint")),
    (8, 4096, 4096, 10, 64, "bfloat16", 4e-3, 1e-2, ("xl_lane_burst",)),
    (8, 1024, 1024, 20, 64, "bfloat16", 4e-3, 1e-2, ("xl_lane_burst",)),
    (1, 4096, 4096, 10, 64, "bfloat16", 4e-3, 1e-2, ("xl_lane_serve",)),
    (1, 1024, 1024, 20, 64, "bfloat16", 4e-3, 1e-2, ("xl_lane_serve",)),
    (2, 1024, 1024, 10, 64, "float32", 2e-4, 1e-4, ("xl_check",)),
    # instruct-pix2pix: SD1.5's UNet on the tripled batch [uncond, image,
    # text + image] of one image
    (3, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("pix2pix_serve",)),
    (3, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("pix2pix_serve",)),
    # the x2 upscaler (widths 384, 768, 768, head dim 64, no CFG) on the 2x
    # latent grid: of a 512 px image (128x128 latents: 6 heads at 16,384
    # tokens, 12 at 4,096 and 1,024) and of a 1024 px SDXL image (256x256:
    # 6 heads at 65,536, 12 at 16,384 and 4,096)
    (1, 16384, 16384, 6, 64, "bfloat16", 4e-3, 1e-2, ("upscale_serve",)),
    (1, 4096, 4096, 12, 64, "bfloat16", 4e-3, 1e-2,
     ("upscale_serve", "xl_upscale_serve")),
    (1, 1024, 1024, 12, 64, "bfloat16", 4e-3, 1e-2, ("upscale_serve",)),
    (1, 65536, 65536, 6, 64, "bfloat16", 4e-3, 1e-2, ("xl_upscale_serve",)),
    (1, 16384, 16384, 12, 64, "bfloat16", 4e-3, 1e-2, ("xl_upscale_serve",)),
    # AudioLDM's UNet at head dim 32: 4 heads over its level-0 latent,
    # 2,560 tokens at a 10 s job and 1,280 at 5 s; CFG doubles the batch,
    # guidance 1.0 does not
    (2, 2560, 2560, 4, 32, "bfloat16", 4e-3, 1e-2, ("audio_serve",)),
    (1, 2560, 2560, 4, 32, "bfloat16", 4e-3, 1e-2, ("audio_serve",)),
    (2, 1280, 1280, 4, 32, "bfloat16", 4e-3, 1e-2, ("audio_serve",)),
    # the video UNets' spatial self-attention over folded frames (head dim
    # 64, 5 heads at the 320-channel level): ModelScope at 256 px, 25 frames
    # bucketed to 32, with CFG (batch 64) and without (32); SVD at 512 px,
    # 14 frames bucketed to 16, CFG (4,096 tokens, and 10 heads at 1,024);
    # vid2vid's SD1.5 at 512x960 (a 16:9 clip at 512 px height) over 8- and
    # 4-frame chunks with CFG
    (64, 1024, 1024, 5, 64, "bfloat16", 4e-3, 1e-2, ("txt2vid_serve",)),
    (32, 1024, 1024, 5, 64, "bfloat16", 4e-3, 1e-2, ("txt2vid_serve",)),
    (32, 4096, 4096, 5, 64, "bfloat16", 4e-3, 1e-2, ("img2vid_serve",)),
    (32, 1024, 1024, 10, 64, "bfloat16", 4e-3, 1e-2, ("img2vid_serve",)),
    (16, 7680, 7680, 8, 40, "bfloat16", 4e-3, 1e-2, ("vid2vid_serve",)),
    (16, 1920, 1920, 8, 80, "bfloat16", 4e-3, 1e-2, ("vid2vid_serve",)),
    (8, 7680, 7680, 8, 40, "bfloat16", 4e-3, 1e-2, ("vid2vid_serve",)),
    (8, 1920, 1920, 8, 80, "bfloat16", 4e-3, 1e-2, ("vid2vid_serve",)),
    # the DeepFloyd cascade: IF-II-L's stage 2 at 256 px (8 heads at 4,096
    # tokens, 16 at 1,024, head dim 64), with CFG and at guidance 1.0; the
    # SD x4 upscaler at a 256x256 latent, always under CFG (8 heads at
    # 16,384 and 4,096 tokens at head dim 64, 8 at 1,024 at head dim 128)
    (2, 4096, 4096, 8, 64, "bfloat16", 4e-3, 1e-2, ("cascade_serve",)),
    (2, 1024, 1024, 16, 64, "bfloat16", 4e-3, 1e-2, ("cascade_serve",)),
    (1, 4096, 4096, 8, 64, "bfloat16", 4e-3, 1e-2, ("cascade_serve",)),
    (1, 1024, 1024, 16, 64, "bfloat16", 4e-3, 1e-2, ("cascade_serve",)),
    (2, 16384, 16384, 8, 64, "bfloat16", 4e-3, 1e-2, ("cascade_serve",)),
    (2, 1024, 1024, 8, 128, "bfloat16", 4e-3, 1e-2, ("cascade_serve",)),
    (1, 1000, 1000, 2, 64, "float32", 2e-4, 1e-4, ()),
    (2, 300, 300, 2, 160, "float32", 2e-4, 1e-4, ()),
    (1, 1000, 333, 4, 32, "float32", 2e-4, 1e-4, ()),
]


# above this many logits (B·H·L·S) the plain version takes a second or
# more a call: it is timed over 3 calls after 1 warm-up, not 20 after 3
PLAIN_FEW_CALLS_LOGITS = 1 << 33


def _held(name: str, shape, out, ref, tol: float, rel_tol: float) -> dict:
    """Hold ``out`` against its plain version ``ref``; raises past a bar."""
    diff = out.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    if not (err <= tol and rel <= rel_tol):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}: max abs error {err} (bar {tol}), "
                             f"relative L2 {rel} (bar {rel_tol})")
    return {"max_abs_err": err, "tolerance": tol, "rel_l2": rel,
            "rel_l2_tolerance": rel_tol,
            "mean_abs_out": ref.float().abs().mean().item()}


def kernel_phase(torch) -> list[dict]:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernel_settings",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for b, l, s, h, d, dtype_name, tol, rel_tol, paths in KERNEL_SHAPES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, l, h, d), generator=gen).to("cuda", dtype)
        k = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
        v = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        shape = [b, l, s, h, d]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        few = b * h * l * s > PLAIN_FEW_CALLS_LOGITS
        plain_calls = {"warmup": 1, "iters": 3} if few else {}
        row = {
            "shape": shape, "dtype": dtype_name,
            "design": design(dtype_name, d),
            **_held("B1", shape, out, flash_attention_plain(q, k, v), tol,
                    rel_tol),
            "served": bool(paths), "paths": list(paths),
            "ms": time_ms(torch, lambda: flash_attention(q, k, v)),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(q, k, v),
                                **plain_calls),
            "plain_timed_calls": plain_calls.get("iters", 20),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **attention_work(b, l, s, h, d, dtype),
        }
        row["vs_library"] = vs_library(row["ms"], row["library_ms"])
        emit("kernel", name="flash_attention", **row)
        rows.append(row)
    return rows


def ring_hop_work(b: int, l: int, s: int, h: int, d: int, dtype) -> dict:
    """FLOPs and bytes one ring hop needs: the attention's 4·B·H·L·S·D,
    q, k and v read once in their type, and the float32 state m, l (B, H, L)
    and acc (B, L, H, D) read once and written once."""
    elem = dtype.itemsize
    return bound(4 * b * h * l * s * d,
                 (b * l * h * d + 2 * b * s * h * d) * elem
                 + 2 * (2 * b * h * l + b * l * h * d) * 4, dtype)


def ring_mesh_devices(torch) -> list:
    """The devices of the seq = 4 mesh: four cards when four are visible,
    else the first card named four times."""
    if torch.cuda.device_count() >= RING_SHARDS:
        return [torch.device("cuda", i) for i in range(RING_SHARDS)]
    return [torch.device("cuda", 0)] * RING_SHARDS


def ring_mesh(torch, devices=None):
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec({"seq": RING_SHARDS}),
                      devices=devices or ring_mesh_devices(torch))


def one_card_devices(torch) -> list:
    """The mesh B3 serves: the first card named once per shard."""
    return [torch.device("cuda", 0)] * RING_SHARDS


@contextlib.contextmanager
def env(**values: str):
    """The environment variables ``values`` set for the block, then
    restored."""
    old = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


# B2 shapes: the query shard, a K/V shard, and the launches per job of the
# sequence-parallel serve path (20 steps x 5 self-attentions x 16 per level,
# 16 for the VAE mid block)
RING_SHAPES = [
    # (B, L, S, H, D, dtype, max abs error, relative L2, launches per job)
    (2, 1024, 1024, 8, 40, "bfloat16", 4e-3, 1e-2, 1600),
    (2, 256, 256, 8, 80, "bfloat16", 4e-3, 1e-2, 1600),
    (1, 1024, 1024, 1, 512, "bfloat16", 4e-3, 1e-2, 16),
    (2, 300, 170, 2, 64, "bfloat16", 4e-3, 1e-2, 0),  # ragged, strided q
    (1, 300, 170, 2, 64, "float32", 2e-4, 1e-4, 0),
]


def ring_kernel_phase(torch) -> list[dict]:
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        ring_flash_hop,
        ring_flash_hop_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(2)
    rows = []
    for b, l, s, h, d, dtype_name, tol, rel_tol, per_job in RING_SHAPES:
        dtype = getattr(torch, dtype_name)

        def randn(*shape):
            return torch.randn(shape, generator=gen).to("cuda", dtype)

        # query shard 1 of 4 of a (B, 4L, H, D) tensor, as the ring hands
        # it to B2 (strided across the batch when B > 1)
        q = randn(b, RING_SHARDS * l, h, d)[:, l:2 * l]
        k0, v0, k, v = (randn(b, s, h, d) for _ in range(4))
        scale = d ** -0.5
        state = ring_flash_hop_plain(
            q, k0, v0, torch.full((b, h, l), -1e30, device="cuda"),
            torch.zeros((b, h, l), device="cuda"),
            torch.zeros((b, l, h, d), device="cuda"), scale=scale)
        m, lsum, acc = (t.clone() for t in state)
        ring_flash_hop(q, k, v, m, lsum, acc)
        torch.cuda.synchronize()
        ref_m, ref_l, ref_acc = ring_flash_hop_plain(q, k, v, *state,
                                                     scale=scale)
        shape = [b, l, s, h, d]
        m_err = (m - ref_m).abs().max().item()
        l_err = ((lsum - ref_l).abs() / ref_l).max().item()
        if not (m_err <= 1e-5 and l_err <= 1e-4):
            raise AssertionError(f"B2 state disagrees with its plain version "
                                 f"at {shape}: m max abs error {m_err} (bar "
                                 f"1e-5), l max relative error {l_err} (bar "
                                 f"1e-4)")
        row = {
            "shape": shape, "dtype": dtype_name,
            "design": design(dtype_name, d),
            "strided_q": not q.is_contiguous(),
            "launches_per_job": per_job, "served": per_job > 0,
            **_held("B2", shape, acc / lsum.transpose(1, 2)[..., None],
                    ref_acc / ref_l.transpose(1, 2)[..., None],
                    tol, rel_tol),
            "m_max_abs_err": m_err, "l_max_rel_err": l_err,
            "ms": time_ms(torch, lambda: ring_flash_hop(q, k, v, m, lsum,
                                                        acc)),
            "host_ms": host_ms(torch, lambda: ring_flash_hop(q, k, v, m, lsum,
                                                             acc)),
            "plain_ms": time_ms(torch, lambda: ring_flash_hop_plain(
                q, k, v, *state, scale=scale)),
            "library_ms": None,
            **ring_hop_work(b, l, s, h, d, dtype),
        }
        if not torch.isfinite(acc).all():
            raise AssertionError(f"B2 state went non-finite at {shape}")
        emit("ring_kernel", name="ring_flash_hop", **row)
        rows.append(row)

    return rows


# B3 shapes: the whole ring attention (q = k/v length) of a solo job on the
# seq slot (5 self-attentions per UNet level a step), of a lane of 8 rows
# there (16 UNet rows with CFG), and of the VAE mid block (one a decode)
FUSED_SHAPES = [
    # (B, L, S, H, D, dtype, max abs error, relative L2, the phases that
    # launch it)
    (2, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("seq_serve",)),
    (2, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("seq_serve",)),
    (16, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("lane_seq_serve",)),
    (16, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("lane_seq_serve",)),
    (1, 4096, 4096, 1, 512, "bfloat16", 4e-3, 1e-2,
     ("seq_serve", "lane_seq_serve")),
    (1, 600, 680, 2, 64, "float32", 2e-4, 1e-4, ()),
]


def fused_kernel_phase(torch) -> list[dict]:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import flash_attention_plain
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        ring_flash_attention,
        ring_flash_fused,
        ring_flash_fused_plain,
    )

    mesh = ring_mesh(torch, one_card_devices(torch))
    gen = torch.Generator(device="cpu").manual_seed(4)
    rows = []
    for b, l, s, h, d, dtype_name, tol, rel_tol, paths in FUSED_SHAPES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, l, h, d), generator=gen).to("cuda", dtype)
        k, v = (torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
                for _ in range(2))
        scale = d ** -0.5
        out = ring_flash_fused(q, k, v, shards=RING_SHARDS)
        with env(CHIASWARM_RING_FLASH="scan"):
            scan = ring_flash_attention(q, k, v, mesh=mesh)
        torch.cuda.synchronize()
        shape = [b, l, s, h, d]
        unsharded = flash_attention_plain(q, k, v)
        _held("B3 against unsharded flash", shape, out, unsharded, tol,
              rel_tol)
        _held("B3 against the B2 scan drive", shape, out, scan, tol, rel_tol)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def scan_ring():
            with env(CHIASWARM_RING_FLASH="scan"):
                ring_flash_attention(q, k, v, mesh=mesh)

        row = {
            "shape": shape, "dtype": dtype_name, "shards": RING_SHARDS,
            "design": design(dtype_name, d),
            "served": bool(paths), "paths": list(paths),
            **_held("B3", shape, out, ring_flash_fused_plain(
                q, k, v, shards=RING_SHARDS, scale=scale), tol, rel_tol),
            "max_abs_err_vs_unsharded": (out.float() - unsharded.float())
            .abs().max().item(),
            "max_abs_err_vs_scan": (out.float() - scan.float())
            .abs().max().item(),
            "bit_equal_vs_scan": bool(torch.equal(out, scan)),
            "ms": time_ms(torch, lambda: ring_flash_fused(
                q, k, v, shards=RING_SHARDS)),
            "host_ms": host_ms(torch, lambda: ring_flash_fused(
                q, k, v, shards=RING_SHARDS)),
            "plain_ms": time_ms(torch, lambda: ring_flash_fused_plain(
                q, k, v, shards=RING_SHARDS, scale=scale)),
            "scan_ms": time_ms(torch, scan_ring),
            "scan_host_ms": host_ms(torch, scan_ring),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **attention_work(b, l, s, h, d, dtype),
        }
        row["vs_library"] = vs_library(row["ms"], row["library_ms"])
        if not torch.isfinite(out).all():
            raise AssertionError(f"B3 output went non-finite at {shape}")
        emit("fused_kernel", name="ring_flash_fused", **row)
        rows.append(row)
    return rows


def check_phase(torch) -> None:
    """Full-width SD1.5 UNet, float32, 32x32 latents (1024 tokens at the
    first level, so B1 runs there): kernel route against the plain route.
    Both runs share every other op; only float32 summation order differs.
    Then the same weights in bf16 at 64x64 latents (B1's tensor-core route
    at both of its serve shapes) against the plain route, within the repo's
    bf16 parity bar."""
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL
    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    fam = FAMILIES["sd15"]
    with torch.device("meta"):
        unet = UNet(fam.unet)
    unet = unet.to_empty(device="cuda").eval().requires_grad_(False)
    flax_default_init(unet, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((2, 4, 32, 32), generator=gen).cuda()
    ctx = torch.randn((2, 77, 768), generator=gen).cuda()
    t = torch.tensor([999.0, 10.5], device="cuda")
    with torch.inference_mode():
        set_attn_impl(unet, "auto")
        before = KERNEL.launches
        out_kernel = unet(x, t, ctx)
        launches = KERNEL.launches - before
        set_attn_impl(unet, "xla")
        out_plain = unet(x, t, ctx)
    torch.cuda.synchronize()
    rel = ((out_kernel - out_plain).norm() / out_plain.norm()).item()
    finite = bool(torch.isfinite(out_kernel).all())
    emit("check", model="sd15 unet fp32", latent=[2, 4, 32, 32],
         b1_launches=launches, rel_l2=rel, finite=finite, tolerance=1e-4)
    # 32x32 latents: 1024 tokens at the first level only, where 2 down and
    # 3 up transformer blocks run their self-attention through B1
    if launches != 5 or not finite or not rel <= 1e-4:
        raise AssertionError(f"UNet kernel route check failed: launches "
                             f"{launches} (want 5), finite {finite}, "
                             f"relative L2 {rel}")
    del out_kernel, out_plain

    # bf16, the serve dtype, at 64x64 latents: B1's tensor-core route (p
    # rounded to bf16 for P·V) against the plain route's fp32 logits
    cast_module(unet, torch.bfloat16)  # as the serve path: norms stay fp32
    x = torch.randn((2, 4, 64, 64), generator=gen).cuda().to(torch.bfloat16)
    ctx = ctx.to(torch.bfloat16)
    with torch.inference_mode():
        set_attn_impl(unet, "auto")
        before = KERNEL.launches
        out_kernel = unet(x, t, ctx).float()
        launches = KERNEL.launches - before
        set_attn_impl(unet, "xla")
        out_plain = unet(x, t, ctx).float()
    torch.cuda.synchronize()
    rel = ((out_kernel - out_plain).norm() / out_plain.norm()).item()
    finite = bool(torch.isfinite(out_kernel).all())
    emit("check", model="sd15 unet bf16", latent=[2, 4, 64, 64],
         b1_launches=launches, rel_l2=rel, finite=finite, tolerance=3e-2,
         design=design("bfloat16", 40))
    # 64x64 latents: 4096 tokens at the first level and 1024 at the second,
    # five self-attentions each through B1
    if launches != 10 or not finite or not rel <= 3e-2:
        raise AssertionError(f"bf16 UNet kernel route check failed: launches "
                             f"{launches} (want 10), finite {finite}, "
                             f"relative L2 {rel} (bar 3e-2)")
    del unet
    torch.cuda.empty_cache()


def ring_check_phase(torch) -> None:
    """Full-width SD1.5 UNet (32x32 latents) and VAE decode (64x64 latent)
    in float32, under the seq = 4 mesh against the single-device plain
    route, once through B3 (the shards share cuda:0) and once through the
    scan drive over B2; only float32 summation order differs."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.models.vae import AutoencoderKL
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )
    from chiaswarm_tpu_torch.ops.ring_flash_attention import KERNEL as B2
    from chiaswarm_tpu_torch.parallel.context import sequence_parallel
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    fam = FAMILIES["sd15"]
    drives = (("fused", "", B3, one_card_devices(torch)),
              ("scan", "scan", B2, ring_mesh_devices(torch)))
    gen = torch.Generator(device="cpu").manual_seed(3)
    results = {}
    # five 1024-token self-attentions in the UNet, one in the VAE mid block
    for name, ctor, cfg, rings in (("unet", UNet, fam.unet, 5),
                                   ("vae", AutoencoderKL, fam.vae, 1)):
        with torch.device("meta"):
            module = ctor(cfg)
        module = module.to_empty(device="cuda").eval().requires_grad_(False)
        flax_default_init(module, torch.Generator(device="cuda").manual_seed(0))
        if name == "unet":
            args = (torch.randn((2, 4, 32, 32), generator=gen).cuda(),
                    torch.tensor([999.0, 10.5], device="cuda"),
                    torch.randn((2, 77, 768), generator=gen).cuda())
            fn = module
        else:
            args = (torch.randn((1, 4, 64, 64), generator=gen).cuda(),)
            fn = module.decode
        with torch.inference_mode():
            if name == "unet":
                set_attn_impl(module, "xla")
            out_local = fn(*args)
            if name == "unet":
                set_attn_impl(module, "auto")
            for drive, mode, kernel, devices in drives:
                mesh = ring_mesh(torch, devices)
                want = rings * (1 if kernel is B3 else RING_SHARDS ** 2)
                kernels.reset_launches()
                with env(CHIASWARM_RING_FLASH=mode), sequence_parallel(mesh):
                    out_ring = fn(*args)
                launches = {n: k.launches for n, k in kernels.KERNELS.items()}
                torch.cuda.synchronize()
                rel = ((out_ring - out_local).norm() / out_local.norm()).item()
                finite = bool(torch.isfinite(out_ring).all())
                results[f"{name}_{drive}"] = {
                    "shape": list(args[0].shape), "launches": launches,
                    "rel_l2": rel, "finite": finite,
                    "mesh_devices": [str(dv) for dv in mesh.device_list]}
                if (launches[kernel.name] != want
                        or sum(launches.values()) != want
                        or not finite or not rel <= 1e-4):
                    raise AssertionError(
                        f"ring check of the sd15 {name} ({drive}) failed: "
                        f"launches {launches} (want {want} of {kernel.name} "
                        f"and no other), finite {finite}, relative L2 {rel} "
                        "(bar 1e-4)")
                del out_ring
        if name == "unet":
            results["unet_bf16_scan"] = ring_check_unet_bf16(torch, module,
                                                             gen)
        del module, out_local
        torch.cuda.empty_cache()
    emit("ring_check", model="sd15 unet + vae fp32, unet bf16",
         tolerance=1e-4, bf16_tolerance=3e-2, **results)


def ring_check_unet_bf16(torch, unet, gen) -> dict:
    """The UNet in bf16, the serve dtype, at 64x64 latents (4096 tokens at
    the first level, 1024 at the second) under the scan drive on the seq = 4
    mesh: B2's tensor-core route at both of its serve shapes, against the
    single-device plain route, within the repo's bf16 parity bar."""
    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import KERNEL as B2
    from chiaswarm_tpu_torch.parallel.context import sequence_parallel
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    cast_module(unet, torch.bfloat16)  # as the serve path: norms stay fp32
    x = torch.randn((2, 4, 64, 64), generator=gen).cuda().to(torch.bfloat16)
    ctx = torch.randn((2, 77, 768), generator=gen).cuda().to(torch.bfloat16)
    t = torch.tensor([999.0, 10.5], device="cuda")
    mesh = ring_mesh(torch)
    with torch.inference_mode():
        set_attn_impl(unet, "xla")
        out_local = unet(x, t, ctx).float()
        set_attn_impl(unet, "auto")
        kernels.reset_launches()
        with env(CHIASWARM_RING_FLASH="scan"), sequence_parallel(mesh):
            out_ring = unet(x, t, ctx).float()
        launches = {n: k.launches for n, k in kernels.KERNELS.items()}
    torch.cuda.synchronize()
    rel = ((out_ring - out_local).norm() / out_local.norm()).item()
    finite = bool(torch.isfinite(out_ring).all())
    want = B2_LAUNCHES_PER_UNET_EVAL
    if (launches[B2.name] != want or sum(launches.values()) != want
            or not finite or not rel <= 3e-2):
        raise AssertionError(
            f"bf16 ring check of the sd15 unet (scan) failed: launches "
            f"{launches} (want {want} of {B2.name} and no other), finite "
            f"{finite}, relative L2 {rel} (bar 3e-2)")
    return {"shape": list(x.shape), "launches": launches, "rel_l2": rel,
            "finite": finite, "design": design("bfloat16", 40),
            "mesh_devices": [str(dv) for dv in mesh.device_list]}


def png_hw(blob_b64: str) -> tuple[int, int]:
    blob = base64.b64decode(blob_b64)
    if blob[:8] != b"\x89PNG\r\n\x1a\n" or blob[12:16] != b"IHDR":
        raise AssertionError("artifact blob is not a PNG")
    width, height = struct.unpack(">II", blob[16:24])
    return height, width


JOBS = [{"id": f"smoke-sd15-{seed}", "model_name": "sd15",
         "prompt": "a lighthouse on a cliff at golden hour, oil painting",
         "negative_prompt": "blurry, low quality" if seed == 2 else "",
         "num_inference_steps": SERVE_STEPS, "guidance_scale": 7.5,
         "height": 512, "width": 512, "seed": seed,
         "content_type": "image/png"} for seed in (1, 2, 3)][:SERVE_JOBS]


def check_envelope(phase: str, job: dict, result: dict, lanes: bool) -> str:
    """Raises on an error envelope, a PNG that is not the job's height x
    width, or (with ``lanes``) a job a lane did not serve. Returns the PNG
    blob."""
    cfg = result["pipeline_config"]
    if "error" in cfg:
        raise AssertionError(f"{phase} job {job['id']} failed: "
                             f"{cfg['error']}")
    if lanes and "stepper" not in cfg:
        raise AssertionError(f"{phase} job {job['id']} fell back to the "
                             "per-job path: no stepper stamp")
    if not lanes and "stepper" in cfg:
        raise AssertionError(f"{phase} job {job['id']} rode a lane on the "
                             "solo path")
    blob = result["artifacts"]["primary"]["blob"]
    hw, want = png_hw(blob), (job["height"], job["width"])
    if hw != want:
        raise AssertionError(f"{phase} job {job['id']} PNG is {hw}, "
                             f"not {want}")
    return blob


def run_jobs(torch, phase: str, slot, registry, lanes: bool = False,
             jobs=None, spans: list | None = None,
             configs: list | None = None) -> tuple[list, dict]:
    """The serve jobs (or ``jobs``) through ``synchronous_do_work`` on
    ``slot``, one after another, with every launch count set to 0 just
    before, each under a trace of its own (its executor spans: format, text
    encode, lane wait or steps, decode, PNG and base64; appended to
    ``spans``; each envelope's config to ``configs``). Returns the job
    seconds and each job's PNG blob by seed; raises on an error envelope, a
    wrong PNG, or a job on the wrong path (``lanes``)."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.obs import trace as obs_trace
    from chiaswarm_tpu_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    seconds, blobs = [], {}
    for job in JOBS if jobs is None else jobs:
        job = dict(job)
        trace = obs_trace.JobTrace(id=job["id"])
        obs_trace.attach(job, trace)
        trace.phase("execute")
        t1 = time.perf_counter()
        result = synchronous_do_work(job, slot, registry)
        seconds.append(time.perf_counter() - t1)
        trace.finish(obs_trace.TraceRing())
        rows = span_rows(trace)
        if spans is not None:
            spans.append(rows)
        cfg = result["pipeline_config"]
        blobs[job["seed"]] = check_envelope(phase, job, result, lanes)
        if configs is not None:
            configs.append(cfg)
        emit(f"{phase}_job", id=job["id"], seed=cfg["seed"],
             seconds=seconds[-1], generation_s=cfg["generation_s"],
             scheduler=cfg["scheduler"],
             png_hw=[job["height"], job["width"]],
             mesh_shape=cfg["slot"]["mesh_shape"],
             stepper=cfg.get("stepper"), spans=rows)
    return seconds, blobs


def load_pipeline(torch, phase: str, registry, mesh=None) -> None:
    t0 = time.perf_counter()
    # Components.random(sd15, seed 0, the slot's lead card, the family's bf16)
    pipe = registry.pipeline("sd15", mesh=mesh)
    torch.cuda.synchronize()
    emit(f"{phase}_load", model="sd15", load_s=round(time.perf_counter() - t0, 3),
         param_bytes=pipe.c.param_bytes(), dtype=str(pipe.c.dtype))


def launched() -> dict:
    """Every kernel's launches since the counts were last set to 0, in all
    and by shape (B, L, S, H, D, dtype)."""
    from chiaswarm_tpu_torch.ops import kernels

    return {name: {"launches": k.launches, "shapes": dict(k.shapes)}
            for name, k in kernels.KERNELS.items()}


def shape_key(row: dict) -> tuple:
    return (*row["shape"], row["dtype"])


def check_held(runs: dict, tables: dict) -> None:
    """Every shape at which a served phase launched a kernel is one that
    its kernel phase held against the plain version; prints each phase's
    launches by shape."""
    for phase, run in runs.items():
        for name, rows in tables.items():
            held = {shape_key(r) for r in rows}
            unheld = sorted(k for k in run[name]["shapes"] if k not in held)
            if unheld:
                raise AssertionError(
                    f"{phase} launched {name} at {unheld}: no kernel phase "
                    "held it against its plain version at those shapes")
    emit("shapes_held", **{phase: {
        name: [[*key, n] for key, n in run[name]["shapes"].items()]
        for name in tables} for phase, run in runs.items()})


def serve_phase(torch, registry, slot) -> tuple[dict, dict]:
    from chiaswarm_tpu_torch.ops import kernels

    load_pipeline(torch, "serve", registry)
    seconds, blobs = run_jobs(torch, "serve", slot, registry)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    want = len(JOBS) * SERVE_STEPS * B1_LAUNCHES_PER_UNET_EVAL
    emit("serve", jobs=len(JOBS), steps=SERVE_STEPS, job_seconds=seconds,
         images_per_s=len(JOBS) / sum(seconds),
         images_per_s_after_first=(len(JOBS) - 1) / sum(seconds[1:]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_flash_launches=want)
    if launches["flash_attention"] != want:
        raise AssertionError(f"B1 launched {launches['flash_attention']} "
                             f"times in the serve phase, expected {want}")
    return launched(), blobs


def decode_png(blob_b64: str):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(blob_b64)))
                      .convert("RGB")).astype("int16")


def seq_serve_phase(torch, phase: str, solo_blobs: dict) -> dict:
    """The serve jobs on a seq = 4 slot: ``seq_serve`` through B3 on the
    one-card mesh, ``seq_serve_scan`` through the scan drive over B2."""
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.mesh import MeshSpec
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )
    from chiaswarm_tpu_torch.ops.ring_flash_attention import KERNEL as B2

    if phase == "seq_serve":
        mode, kernel, devices = "", B3, one_card_devices(torch)
        per_eval, per_decode = B3_LAUNCHES_PER_UNET_EVAL, B3_LAUNCHES_PER_DECODE
    else:
        mode, kernel, devices = "scan", B2, ring_mesh_devices(torch)
        per_eval, per_decode = B2_LAUNCHES_PER_UNET_EVAL, B2_LAUNCHES_PER_DECODE
    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"},
                                      {"name": XL_MODEL, "family": "sdxl"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(mesh_spec=MeshSpec({"seq": RING_SHARDS}),
                    devices=devices).slots[0]
    with env(CHIASWARM_RING_FLASH=mode):
        load_pipeline(torch, phase, registry, mesh=slot.mesh)
        seconds, blobs = run_jobs(torch, phase, slot, registry)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    want = len(JOBS) * (SERVE_STEPS * per_eval + per_decode)
    diffs = {}
    for seed, blob in blobs.items():
        diffs[seed] = int(abs(decode_png(blob)
                              - decode_png(solo_blobs[seed])).max())
    desc = slot.descriptor()
    emit(phase, jobs=len(JOBS), steps=SERVE_STEPS,
         ring_flash_mode=mode or "default", kernel=kernel.name,
         mesh_shape=desc["mesh_shape"], mesh_devices=desc["mesh_devices"],
         repeated_device=desc["repeated_device"],
         job_seconds=seconds, images_per_s=len(JOBS) / sum(seconds),
         images_per_s_after_first=(len(JOBS) - 1) / sum(seconds[1:]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_ring_launches=want,
         max_uint8_diff_vs_serve=diffs)
    if launches[kernel.name] != want or sum(launches.values()) != want:
        raise AssertionError(f"{phase} launched {launches}, expected "
                             f"{want} of {kernel.name} and no other")
    return launched()


# ---------------------------------------------------------------------------
# the continuous-batching lanes (serving/stepper.py), the default engine


def lane_check_phase(torch) -> None:
    """The full-width SD1.5 UNet in float32 (TF32 off) on a 32x32 latent:
    ONE lane step over 4 rows (step counts 20, 12 and 7 at different ladder
    positions, guidance 7.5, 5.0 and 9.0, one inactive row) against each
    row's solo step (a batch-1 CFG UNet call and ``sampler_step``), for
    DPM-Solver++(2M) and Euler. Relative L2 1e-4 on x and the multistep
    history, the inactive row bit for bit, and the lane step itself
    launching B1 5 times (the 1024-token level, whatever the width)."""
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from chiaswarm_tpu_torch.schedulers import (
        SamplerState,
        make_sampling_schedule,
        resolve,
        sampler_step,
        scale_model_input,
    )

    pipe = DiffusionPipeline(Components.random("sd15", seed=0, device="cuda",
                                               dtype=torch.float32))
    steps, idx = (20, 12, 7, 20), (0, 5, 6, 3)
    guidance = torch.tensor([7.5, 5.0, 9.0, 7.5])
    active = torch.tensor([True, True, True, False])
    gen = torch.Generator(device="cpu").manual_seed(6)
    x, old = (torch.randn((4, 4, 32, 32), generator=gen).cuda()
              for _ in range(2))
    ctx_u, ctx_c = (torch.randn((4, 77, 768), generator=gen).cuda()
                    for _ in range(2))
    results = {}
    for name in (None, "EulerDiscreteScheduler"):
        sampler = resolve(name)
        scheds = [make_sampling_schedule(pipe.noise_schedule, n, sampler)
                  for n in steps]
        sig = torch.zeros((4, 33))
        ts = torch.zeros((4, 32))
        for b, sched in enumerate(scheds):
            sig[b, :steps[b] + 1] = sched.sigmas
            ts[b, :steps[b]] = sched.timesteps
        before = KERNEL.launches
        shapes_before = dict(KERNEL.shapes)
        x_l, idx_l, old_l = pipe.stepper_step(
            sampler=sampler, ctx_u=ctx_u, ctx_c=ctx_c, x=x,
            idx=torch.tensor(idx, device="cuda"),
            start_idx=torch.zeros(4, dtype=torch.long, device="cuda"),
            sigmas=sig.cuda(), timesteps=ts.cuda(), guidance=guidance.cuda(),
            old_denoised=old, active=active.cuda(), generators=[None] * 4)
        torch.cuda.synchronize()
        launches = KERNEL.launches - before
        shapes = {key: n - shapes_before.get(key, 0)
                  for key, n in KERNEL.shapes.items()
                  if n != shapes_before.get(key, 0)}
        rels = []
        with torch.inference_mode():
            for b in range(3):
                one = slice(b, b + 1)
                inp = scale_model_input(scheds[b], x[one], idx[b])
                t = scheds[b].timesteps[idx[b]].cuda().expand(2)
                eps_u, eps_c = pipe.c.unet(
                    torch.cat([inp, inp]), t,
                    torch.cat([ctx_u[one], ctx_c[one]])).chunk(2)
                eps = eps_u + float(guidance[b]) * (eps_c - eps_u)
                x_s, state = sampler_step(sampler, scheds[b], idx[b], x[one],
                                          eps, SamplerState(old[one]))
                rels.append([((got - ref).norm() / ref.norm()).item()
                             for got, ref in ((x_l[one], x_s),
                                              (old_l[one],
                                               state.old_denoised))])
        frozen = bool(torch.equal(x_l[3], x[3]) and torch.equal(old_l[3],
                                                                old[3]))
        kind = sampler.kind
        results[kind] = {"b1_launches": launches,
                         "b1_shapes": [[*k, n] for k, n in shapes.items()],
                         "rel_l2_x_old": rels,
                         "inactive_row_bit_equal": frozen,
                         "idx_next": idx_l.tolist()}
        worst = max(max(r) for r in rels)
        # the 1024-token level, 8 UNet rows: a shape the kernel phase holds
        if (shapes != {(8, 1024, 1024, 8, 40, "float32"): 5}
                or launches != 5 or not frozen or not worst <= 1e-4
                or idx_l.tolist() != [1, 6, 7, 3]):
            raise AssertionError(f"lane check ({kind}) failed: {results[kind]}")
    emit("lane_check", model="sd15 unet fp32", latent=[4, 4, 32, 32],
         width=4, steps=list(steps), idx=list(idx),
         guidance=guidance.tolist(), active=active.tolist(), tolerance=1e-4,
         **results)
    del pipe
    torch.cuda.empty_cache()


def stepper_stats(slot) -> dict:
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    return get_stepper(slot).stats()


def delta(after: dict, before: dict, key: str) -> int:
    return after.get(key, 0) - before.get(key, 0)


def lane_serve_phase(torch, registry, slot, solo_blobs: dict) -> tuple:
    """The serve jobs one after another through ``synchronous_do_work`` with
    the lanes on, on the solo slot: each job alone in a lane (adaptive
    width). Every job a lane's; B1 launched 10 times per lane step. Returns
    the launches, the blobs by seed and the jobs' span rows."""
    from chiaswarm_tpu_torch.ops import kernels

    before = stepper_stats(slot)
    spans: list = []
    seconds, blobs = run_jobs(torch, "lane_serve", slot, registry, lanes=True,
                              spans=spans)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    after = stepper_stats(slot)
    steps = delta(after, before, "steps_executed")
    want = steps * B1_LAUNCHES_PER_UNET_EVAL
    emit("lane_serve", jobs=len(JOBS), steps=SERVE_STEPS,
         job_seconds=seconds, images_per_s=len(JOBS) / sum(seconds),
         images_per_s_after_first=(len(JOBS) - 1) / sum(seconds[1:]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         steps_executed=steps, launches=launches,
         expected_flash_launches=want,
         vs_serve=image_diffs(blobs, solo_blobs))
    if launches["flash_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"lane_serve launched {launches}, expected "
                             f"{want} of flash_attention and no other")
    return launched(), blobs, spans


def image_diffs(blobs: dict, ref_blobs: dict) -> dict:
    """Per seed: the largest uint8 difference and the share of values within
    one level, against the reference's image of the same seed."""
    diffs = {}
    for seed, blob in blobs.items():
        diff = abs(decode_png(blob) - decode_png(ref_blobs[seed]))
        diffs[seed] = {"max": int(diff.max()),
                       "within_one": float((diff <= 1).mean()),
                       "bit_equal": bool((diff == 0).all())}
    return diffs


LANE_WIDTH = 8
BURST_JOBS = [{"id": f"burst-sd15-{seed}", "model_name": "sd15",
               "prompt": "a lighthouse on a cliff at golden hour, oil painting",
               "negative_prompt": "blurry, low quality" if seed == 12 else "",
               "num_inference_steps": 20 if seed % 2 else 12,
               "guidance_scale": 7.5 if seed % 2 else 5.0,
               "height": 512, "width": 512, "seed": seed,
               "content_type": "image/png"} for seed in range(11, 19)]
LATE_JOB = dict(BURST_JOBS[0], id="burst-sd15-19", seed=19)


def lane_burst_phase(torch, registry, slot) -> dict:
    """Eight jobs at once through ``synchronous_do_work_batch`` at a pinned
    lane width of 8 (steps 20 and 12, guidance 7.5 and 5.0 alternating),
    and a ninth through ``synchronous_do_work`` from a second thread once
    the lane has executed 5 steps: it waits for the 12-step rows to retire
    and splices in mid-flight. Every job on one lane; B1 launched 10 times
    per lane step, and fewer lane steps than half the jobs' summed steps.
    Then job 11 alone in a lane of the same width: its image within one
    uint8 level of the burst's (the per-row plumbing at one batch shape).
    Returns the burst's launches (``launched``)."""
    import threading

    from chiaswarm_tpu_torch.node.executor import (
        synchronous_do_work,
        synchronous_do_work_batch,
    )
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    get_stepper(slot).shutdown()  # lanes of another width policy
    jobs = BURST_JOBS + [LATE_JOB]
    with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)):
        before = stepper_stats(slot)
        late: dict = {}

        def submit_late():
            # at least 5 lane steps in, from a thread of its own
            while (delta(stepper_stats(slot), before, "steps_executed") < 5
                   and time.perf_counter() - t0 < 600):
                time.sleep(0.002)
            late["submitted_at"] = delta(stepper_stats(slot), before,
                                         "steps_executed")
            late["result"] = synchronous_do_work(dict(LATE_JOB), slot,
                                                 registry)
            late["done_s"] = time.perf_counter() - t0

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        thread = threading.Thread(target=submit_late, name="late-job")
        thread.start()
        results = synchronous_do_work_batch([dict(j) for j in BURST_JOBS],
                                            slot, registry)
        burst_s = time.perf_counter() - t0
        thread.join(timeout=900)
        wall_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        run = launched()
        after = stepper_stats(slot)
        peak = torch.cuda.max_memory_allocated()
        if "result" not in late:
            raise AssertionError("the ninth job never returned")
        results.append(late["result"])
        blobs, infos = {}, {}
        for job, result in zip(jobs, results):
            blobs[job["seed"]] = check_envelope("lane_burst", job, result,
                                                lanes=True)
            infos[job["seed"]] = result["pipeline_config"]["stepper"]
        # job 11 alone in a lane of the same width
        alone = synchronous_do_work(dict(BURST_JOBS[0]), slot, registry)
        alone_blob = check_envelope("lane_burst", BURST_JOBS[0], alone,
                                    lanes=True)
    get_stepper(slot).shutdown()
    steps = delta(after, before, "steps_executed")
    summed = sum(j["num_inference_steps"] for j in jobs)
    want = steps * B1_LAUNCHES_PER_UNET_EVAL
    isolation = image_diffs({11: blobs[11]}, {11: alone_blob})[11]
    lanes_used = {info["lane"] for info in infos.values()}
    row_active = delta(after, before, "row_steps_active")
    row_padded = delta(after, before, "row_steps_padded")
    emit("lane_burst", jobs=len(jobs), lane_width=LANE_WIDTH,
         burst_s=burst_s, wall_s=wall_s, images_per_s=len(jobs) / wall_s,
         late_submitted_at_step=late["submitted_at"],
         late_admitted_at_step=infos[19]["admitted_at_step"],
         steps_executed=steps, summed_job_steps=summed,
         launches=launches, expected_flash_launches=want,
         lane_resizes=delta(after, before, "lane_resizes"),
         row_steps_active=row_active, row_steps_padded=row_padded,
         occupancy=row_active / max(1, row_active + row_padded),
         step_seconds_ewma=after.get("step_seconds_ewma"),
         max_memory_allocated=peak, lanes=sorted(lanes_used),
         generation_s={job["seed"]: result["pipeline_config"]["generation_s"]
                       for job, result in zip(jobs, results)},
         stepper={seed: infos[seed] for seed in sorted(infos)},
         isolation_job_11=isolation)
    if (launches["flash_attention"] != want or sum(launches.values()) != want
            or len(lanes_used) != 1 or infos[19]["admitted_at_step"] < 1
            or not steps < summed / 2 or isolation["max"] > 1):
        raise AssertionError(
            f"lane_burst failed: launches {launches} (want {want} of "
            f"flash_attention), lanes {lanes_used}, ninth job admitted at "
            f"step {infos[19]['admitted_at_step']}, steps {steps} (bar < "
            f"{summed / 2}), isolation {isolation}")
    return run, blobs, len(jobs) / wall_s


def lane_seq_serve_phase(torch) -> dict:
    """Four of the burst jobs through the lanes of the one-card ``seq = 4``
    slot, at a pinned lane width of 8 as in ``lane_burst``: every large
    self-attention of every lane step and every lane decode one B3 launch;
    B1 and B2 never. Returns its launches (``launched``)."""
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.mesh import MeshSpec
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"},
                                      {"name": XL_MODEL, "family": "sdxl"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(mesh_spec=MeshSpec({"seq": RING_SHARDS}),
                    devices=one_card_devices(torch)).slots[0]
    jobs = BURST_JOBS[:4]
    with env(CHIASWARM_RING_FLASH="",
             CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)):
        load_pipeline(torch, "lane_seq_serve", registry, mesh=slot.mesh)
        before = stepper_stats(slot)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                            registry)
        wall_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        run = launched()
        after = stepper_stats(slot)
    get_stepper(slot).shutdown()
    for job, result in zip(jobs, results):
        check_envelope("lane_seq_serve", job, result, lanes=True)
    steps = delta(after, before, "steps_executed")
    decodes = delta(after, before, "rows_completed")  # one row a job
    want = steps * B3_LAUNCHES_PER_UNET_EVAL + decodes * B3_LAUNCHES_PER_DECODE
    desc = slot.descriptor()
    emit("lane_seq_serve", jobs=len(jobs), wall_s=wall_s,
         images_per_s=len(jobs) / wall_s, mesh_shape=desc["mesh_shape"],
         mesh_devices=desc["mesh_devices"], steps_executed=steps,
         decodes=decodes, launches=launches, expected_ring_launches=want,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         stepper=[r["pipeline_config"]["stepper"] for r in results])
    if launches[B3.name] != want or sum(launches.values()) != want:
        raise AssertionError(f"lane_seq_serve launched {launches}, expected "
                             f"{want} of {B3.name} and no other")
    return run


# ---------------------------------------------------------------------------
# checkpoints on disk (convert/, models/tokenizer.py) and the residency
# ledger (serving/residency.py)

CKPT_MODEL = "chip-smoke/sd15"
CKPT_MODEL_B = "chip-smoke/sd15-b"  # a directory of links to CKPT_MODEL's
CKPT_JOBS = [dict(job, id=f"ckpt-sd15-{job['seed']}", model_name=CKPT_MODEL)
             for job in JOBS]
CLIP_VOCAB = 49408
# beyond its modules' bytes, a served model holds its pipeline's small
# device tensors, and the allocator rounds each block up: 5% of the model
MEMORY_SLACK = 0.05


def settings_root_dir() -> Path:
    """The settings root of this run (checkpoints, residency.json, spools):
    under the git-ignored ``build/``, removed when the run ends."""
    return ROOT / "build" / "chip_smoke_root"


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-character table, the alphabet
    CLIP's vocab and CLAP's byte-level vocab are built on."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def synthetic_clip_vocab(seed: int = 0) -> tuple[dict, list]:
    """A CLIP-format vocab made here (nothing is downloaded): the 256 byte
    symbols and their word-final ``</w>`` forms, the left-to-right merges
    that spell the serve jobs' words, then random merges of a piece and a
    letter until the table holds 49,406 pieces (48,894 merges, as the
    published CLIP tokenizer), ``<|startoftext|>`` at 49406 and
    ``<|endoftext|>`` at 49407."""
    import random

    from chiaswarm_tpu_torch.models.tokenizer import _basic_tokens

    rng = random.Random(seed)
    base = list(bytes_to_unicode().values())
    vocab = {piece: i for i, piece in
             enumerate(base + [b + "</w>" for b in base])}
    merges: list[tuple[str, str]] = []
    stems = list(base)

    def merge(a: str, b: str) -> None:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
            merges.append((a, b))
            if not b.endswith("</w>"):
                stems.append(a + b)

    text = " ".join(f"{j['prompt']} {j['negative_prompt']}" for j in JOBS)
    for word in _basic_tokens(text):
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        left = pieces[0]
        for right in pieces[1:]:
            merge(left, right)
            left += right
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    letters += [c + "</w>" for c in letters]
    while len(vocab) < CLIP_VOCAB - 2:
        merge(rng.choice(stems), rng.choice(letters))
    vocab["<|startoftext|>"] = CLIP_VOCAB - 2
    vocab["<|endoftext|>"] = CLIP_VOCAB - 1
    return vocab, merges


def write_clip_vocab(path: Path) -> dict:
    """``synthetic_clip_vocab`` as ``vocab.json`` and ``merges.txt`` in
    ``path`` (a snapshot's ``tokenizer/``)."""
    vocab, merges = synthetic_clip_vocab()
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    return {"vocab": len(vocab), "merges": len(merges)}


def write_checkpoint(torch, components, path: Path,
                     float32: bool = True) -> dict:
    """``components`` as a diffusers-layout snapshot at ``path``: ``unet/``,
    ``vae/``, ``text_encoder/`` (and ``text_encoder_2/`` for a second
    tower) as safetensors through the port's own writer, in float32 (the
    dtype of the published SD1.5 snapshot; bf16 weights round-trip it
    exactly) or, with ``float32=False``, each tensor at the dtype it serves
    at; ``tokenizer/`` from ``synthetic_clip_vocab``. The files are synced
    and advised out of the page cache (``posix_fadvise``), which a
    filesystem may ignore: ``page_cache_share`` reads what it kept."""
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file

    modules = {"unet": components.unet, "vae": components.vae}
    for i, tower in enumerate(components.text_encoders):
        modules["text_encoder" + (f"_{i + 1}" if i else "")] = tower
    files = []
    for sub, module in modules.items():
        (path / sub).mkdir(parents=True, exist_ok=True)
        name = ("model.safetensors" if sub.startswith("text_encoder")
                else "diffusion_pytorch_model.safetensors")
        save_file({k: (v.detach().float() if float32 else v.detach()).cpu()
                   for k, v in module.state_dict().items()},
                  path / sub / name, {"format": "pt"})
        files.append(path / sub / name)
    vocab = write_clip_vocab(path / "tokenizer")
    for file in files:
        fd = os.open(file, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return {"files": {str(f.relative_to(path)): f.stat().st_size
                      for f in files},
            "bytes": sum(f.stat().st_size for f in files), **vocab}


def page_cache_share(paths: list[str]) -> float:
    """The share of the files' pages that the page cache holds now
    (``mincore(2)`` over a private mapping of each file, nothing read)."""
    import ctypes
    import mmap

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_ubyte)]
    held = total = 0
    for path in paths:
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        pages = -(-len(mm) // mmap.PAGESIZE)
        vec = (ctypes.c_ubyte * pages)()
        anchor = ctypes.c_char.from_buffer(mm)
        rc = libc.mincore(ctypes.addressof(anchor), len(mm), vec)
        del anchor
        mm.close()
        if rc != 0:
            raise OSError(ctypes.get_errno(), f"mincore on {path}")
        held += sum(v & 1 for v in vec)
        total += pages
    return held / total


def direct_read(paths: list[str], chunk: int = 64 << 20) -> dict:
    """Every byte of the files read with ``O_DIRECT`` (past the page cache,
    from the disk) into one page-aligned buffer: the read a load pays when
    the cache does not hold its files. ``{"error": ...}`` where the
    filesystem refuses ``O_DIRECT``."""
    import mmap

    buf = mmap.mmap(-1, chunk)
    nbytes = 0
    t0 = time.perf_counter()
    try:
        for path in paths:
            fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
            try:
                while (n := os.readv(fd, [buf])) > 0:
                    nbytes += n
            finally:
                os.close(fd)
    except OSError as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    finally:
        buf.close()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "bytes": nbytes,
            "gb_per_s": nbytes / seconds / 1e9}


def module_states(components) -> dict:
    named = {f"text_encoder_{i}": te
             for i, te in enumerate(components.text_encoders)}
    named.update(unet=components.unet, vae=components.vae)
    return {name: dict(m.named_parameters()) for name, m in named.items()}


class OnePipeline:
    """A registry that serves one pipeline under every name: the reference
    side of an image comparison, on the executor's own path."""

    def __init__(self, pipe) -> None:
        self.pipe = pipe

    def pipeline(self, model_name: str, mesh=None, **adapters):
        return self.pipe


def checkpoint_serve_phase(torch, src_registry, slot, lane_blobs: dict,
                           lane_spans: list) -> tuple[dict, dict]:
    """SD1.5 from a diffusers-layout directory on disk, through a
    ``ModelRegistry`` with no random fallback: the serve phases' seed-0
    weights written as float32 safetensors with a synthetic CLIP vocab
    (``write_checkpoint``), the files read once with ``O_DIRECT`` (the disk's
    read, ``direct_read``), the share of their pages the page cache holds
    (``page_cache_share``), the first load (file read and device copy timed
    apart, the peak of ``max_memory_allocated`` against ``param_bytes`` and
    ``estimate_family_bytes``), every tensor ``torch.equal`` to its source.
    Then a second registry loads the checkpoint while the source model's
    lane steps on another thread: its tensors equal to the source, the lane
    job's image bit for bit lane_serve's seed 1. Then seeds 1-3 one after
    another in the lanes, each image bit for bit the source modules' with
    the loaded tokenizer swapped in at the same lane composition, B1 at 10
    launches a lane step, and each job's spans beside lane_serve's. Returns
    the launches (``launched``) and what later phases need."""
    import dataclasses
    import gc
    import shutil
    import threading

    from chiaswarm_tpu_torch.models.tokenizer import ClipBpeTokenizer
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.pipelines.components import (
        estimate_family_bytes,
    )
    from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    src = src_registry.pipeline("sd15").c
    source = module_states(src)
    path = model_dir(CKPT_MODEL)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    written = write_checkpoint(torch, src, path)
    write_s = time.perf_counter() - t0
    disk = shutil.disk_usage(path)
    paths = [str(path / name) for name in written["files"]]
    direct = direct_read(paths)

    def unequal_to_source(components) -> list[str]:
        loaded = module_states(components)
        return [f"{m}.{k}" for m, params in source.items()
                for k, p in params.items()
                if loaded[m][k].dtype != p.dtype
                or not torch.equal(loaded[m][k], p)]

    registry = ModelRegistry(catalog=[{"name": CKPT_MODEL,
                                       "family": "sd15"}], device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cached = page_cache_share(paths)
    t0 = time.perf_counter()
    pipe = registry.pipeline(CKPT_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    unequal = unequal_to_source(pipe.c)
    tokenizer = pipe.c.tokenizers[0]
    ids = tokenizer.encode(JOBS[0]["prompt"])
    footprint = pipe.c.param_bytes()
    out = {
        "model": CKPT_MODEL, "files": written, "write_s": write_s,
        "disk_free_bytes": disk.free, "disk_total_bytes": disk.total,
        "direct_read": direct, "page_cache_share_at_load": cached,
        "cold_load_s": load_s, "load_stats": pipe.c.load_stats,
        "load_other_s": load_s - pipe.c.load_stats["read_s"]
        - pipe.c.load_stats["copy_s"],
        "load_peak_bytes": peak, "param_bytes": footprint,
        "estimate_family_bytes": estimate_family_bytes("sd15"),
        "tensors_checked": sum(len(v) for v in source.values()),
        "tensors_unequal": unequal[:8], "tokenizer": type(tokenizer).__name__,
        "prompt_ids": ids[:ids.index(tokenizer.eos_id) + 1],
        "residency": registry.residency.snapshot()}
    ref_pipe = DiffusionPipeline(dataclasses.replace(
        src, tokenizers=pipe.c.tokenizers))
    del pipe

    # a load while another model's lane steps on the card's one stream
    sched = get_stepper(slot)
    sched.shutdown()
    lane_job = dict(JOBS[0], id="under-load-sd15-1")
    done: dict = {}
    runner = threading.Thread(target=lambda: done.update(
        result=synchronous_do_work(dict(lane_job), slot, src_registry)))
    start = stepper_stats(slot).get("steps_executed", 0)
    runner.start()
    while (stepper_stats(slot).get("steps_executed", 0) - start < 3
           and runner.is_alive()):
        time.sleep(0.001)
    at_load = stepper_stats(slot).get("steps_executed", 0) - start
    second = ModelRegistry(catalog=[{"name": CKPT_MODEL, "family": "sd15"}],
                           device="cuda")
    t0 = time.perf_counter()
    pipe2 = second.pipeline(CKPT_MODEL)
    torch.cuda.synchronize()
    under_s = time.perf_counter() - t0
    after_load = stepper_stats(slot).get("steps_executed", 0) - start
    runner.join()
    sched.shutdown()
    under_blob = check_envelope("checkpoint_serve", lane_job, done["result"],
                                lanes=True)
    out["load_under_lane"] = {
        "load_s": under_s, "load_stats": pipe2.c.load_stats,
        "lane_steps_before_load": at_load, "lane_steps_after_load": after_load,
        "tensors_unequal": unequal_to_source(pipe2.c)[:8],
        "vs_lane_serve": image_diffs({1: under_blob}, {1: lane_blobs[1]})[1]}
    del pipe2, second
    gc.collect()

    before_stats = stepper_stats(slot)
    spans: list = []
    seconds, blobs = run_jobs(torch, "checkpoint_serve", slot, registry,
                              lanes=True, jobs=CKPT_JOBS, spans=spans)
    run = launched()  # run_jobs set every count to 0 first
    steps = delta(stepper_stats(slot), before_stats, "steps_executed")
    b1 = run["flash_attention"]["launches"]
    sched.shutdown()
    ref_spans: list = []
    ref_seconds, ref_blobs = run_jobs(torch, "checkpoint_serve_reference",
                                      slot, OnePipeline(ref_pipe),
                                      lanes=True, jobs=CKPT_JOBS,
                                      spans=ref_spans)
    sched.shutdown()
    diffs = image_diffs(blobs, ref_blobs)
    keys = sorted({k for row in spans + lane_spans for k in row})
    out.update({"job_seconds": seconds, "reference_job_seconds": ref_seconds,
                "spans": spans, "reference_spans": ref_spans,
                "lane_serve_spans": lane_spans,
                "minus_lane_serve_s": {
                    k: [a.get(k, 0.0) - b.get(k, 0.0)
                        for a, b in zip(spans, lane_spans)] for k in keys},
                "steps_executed": steps, "b1_launches": b1,
                "vs_source_modules": diffs})
    emit("checkpoint_serve", **out)
    under = out["load_under_lane"]
    if (unequal or not isinstance(tokenizer, ClipBpeTokenizer)
            or b1 != steps * B1_LAUNCHES_PER_UNET_EVAL
            or not all(d["bit_equal"] for d in diffs.values())
            or under["tensors_unequal"]
            or not under["vs_lane_serve"]["bit_equal"]
            or not at_load < under["lane_steps_after_load"]):
        raise AssertionError(f"checkpoint_serve: {out}")
    return run, {"registry": registry, "blobs": blobs,
                 "footprint": footprint}


def residency_churn_phase(torch, slot, ckpt: dict) -> dict:
    """Two catalog names over the one checkpoint (``CKPT_MODEL_B`` is a
    directory of links) under a ledger that holds one model (budget 1.5x
    the measured footprint): A served in a lane; B's load evicts A and
    retires A's lane at drain, ``memory_allocated`` back within one model
    (and ``MEMORY_SLACK``) of the level before A, the ledger's peak of
    resident + reserved bytes at most budget + one model; B served; A
    reloaded renders its first image bit for bit. Then the rungs: a budget
    below one model degrades A to load-per-job (``lane_resident_ok`` false,
    the job solo, ``residency: per_job``, the image bit for bit the solo
    path's on the checkpoint registry); a hard limit below the footprint
    gives a non-fatal ``model_unavailable`` envelope."""
    import gc

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.residency import (
        ResidencyManager,
        default_hard_limit_bytes,
    )
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    footprint = ckpt["footprint"]
    link = model_dir(CKPT_MODEL_B)
    link.mkdir(parents=True, exist_ok=True)
    for sub in model_dir(CKPT_MODEL).iterdir():
        if not (link / sub.name).exists():
            (link / sub.name).symlink_to(sub.resolve(),
                                         target_is_directory=True)
    budget = int(1.5 * footprint)
    ledger = ResidencyManager(
        budget, default_hard_limit_bytes(budget, "cuda"),
        persist_path=settings_root_dir() / "residency-churn.json",
        prefetch=False)
    registry = ModelRegistry(
        catalog=[{"name": CKPT_MODEL, "family": "sd15"},
                 {"name": CKPT_MODEL_B, "family": "sd15"}],
        device="cuda", residency=ledger)
    sched = get_stepper(slot)
    sched.shutdown()
    kernels.reset_launches()
    job_a = dict(CKPT_JOBS[0], id="churn-a-1")
    out: dict = {"budget_bytes": budget, "footprint": footprint}

    def serve(job, lanes=True) -> tuple[str, dict]:
        t0 = time.perf_counter()
        result = synchronous_do_work(dict(job), slot, registry)
        seconds = time.perf_counter() - t0
        cfg = result["pipeline_config"]
        return check_envelope("residency_churn", job, result, lanes), {
            "seconds": seconds, "generation_s": cfg.get("generation_s"),
            "stepper": cfg.get("stepper"), "residency": cfg.get("residency")}

    def timed_load(model: str) -> float:
        t0 = time.perf_counter()
        registry.pipeline(model)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def owners() -> set:
        return {id(key[0].c) for key in list(sched._lanes)}

    gc.collect()
    torch.cuda.synchronize()
    level0 = torch.cuda.memory_allocated()
    out["load_a_s"] = timed_load(CKPT_MODEL)
    owner_a = id(registry.pipeline(CKPT_MODEL).c)
    blob_a1, out["a_first"] = serve(job_a)
    level_a = torch.cuda.memory_allocated()
    ledger.reset_peak()

    t0 = time.perf_counter()
    registry.pipeline(CKPT_MODEL_B)
    torch.cuda.synchronize()
    out["evict_and_load_b_s"] = time.perf_counter() - t0
    while owner_a in owners() and time.perf_counter() - t0 < 60:
        time.sleep(0.01)
    out["a_lane_retired_after_s"] = time.perf_counter() - t0
    out["a_lane_retired"] = owner_a not in owners()
    gc.collect()
    torch.cuda.synchronize()
    level_b = torch.cuda.memory_allocated()
    out.update({"level_before_a": level0, "level_a_resident": level_a,
                "level_after_eviction": level_b,
                "above_level_before_a": level_b - level0,
                "memory_reserved": torch.cuda.memory_reserved(),
                "ledger_peak_bytes": ledger.peak_bytes,
                "states_after_b": registry.model_states()})
    blob_b, out["b"] = serve(dict(CKPT_JOBS[0], id="churn-b-1",
                                  model_name=CKPT_MODEL_B))
    out["reload_a_s"] = timed_load(CKPT_MODEL)
    blob_a2, out["a_again"] = serve(dict(job_a, id="churn-a-1-again"))
    out["a_again_bit_equal"] = blob_a2 == blob_a1
    out["b_bit_equal_a"] = blob_b == blob_a1
    sched.shutdown()
    snap = ledger.snapshot()
    failed = []
    if (snap["evictions"] != 2 or not out["a_lane_retired"]
            or level_b - level0 > footprint * (1 + MEMORY_SLACK)
            or out["ledger_peak_bytes"] > budget + footprint
            or out["states_after_b"] != {CKPT_MODEL: "evicted",
                                         CKPT_MODEL_B: "resident"}
            or not out["a_again_bit_equal"]):
        failed.append("eviction")

    # rung 1: a budget below one model degrades A to load-per-job
    ledger.set_budget(footprint // 2)
    out["lane_resident_ok_degraded"] = registry.lane_resident_ok(CKPT_MODEL)
    blob_deg, out["degraded"] = serve(dict(job_a, id="churn-a-1-degraded"),
                                      lanes=False)
    with env(CHIASWARM_STEPPER="0"):
        solo = synchronous_do_work(dict(job_a, id="churn-a-1-solo"), slot,
                                   ckpt["registry"])
    blob_solo = check_envelope("residency_churn", job_a, solo, lanes=False)
    out["degraded_bit_equal_solo"] = blob_deg == blob_solo
    gc.collect()
    out["reserved_after_degraded_job"] = ledger.reserved_bytes
    if (out["lane_resident_ok_degraded"] or not out["degraded_bit_equal_solo"]
            or out["degraded"]["residency"] != "per_job"
            or out["reserved_after_degraded_job"] != 0):
        failed.append("degrade")

    # rung 2: a hard limit below the footprint bounces the job
    ledger.set_budget(footprint // 4, footprint // 2)
    bounced = synchronous_do_work(dict(job_a, id="churn-a-2-bounce", seed=2),
                                  slot, registry)
    cfg = bounced["pipeline_config"]
    out["bounce"] = {"error_kind": cfg.get("error_kind"),
                     "fatal_error": bool(bounced.get("fatal_error")),
                     "error": cfg.get("error")}
    if cfg.get("error_kind") != "model_unavailable" or "fatal_error" in bounced:
        failed.append("bounce")
    run = launched()
    out["snapshot"] = ledger.snapshot()
    out["states"] = registry.model_states()
    sched.shutdown()
    emit("residency_churn", **out)
    if failed:
        raise AssertionError(f"residency_churn ({', '.join(failed)}): {out}")
    return run


# ---------------------------------------------------------------------------
# the hive worker (node/worker.py): poll -> lanes -> upload


class LocalHive:
    """The hive protocol's three endpoints (``GET /api/work``, ``POST
    /api/results``, ``GET /api/models``) on ``127.0.0.1``, served from a
    thread of this script by the standard library's ``http.server``. Every
    poll hands out every queued job (the reference hive's semantics).
    ``faults`` maps a job id to the HTTP statuses its first uploads get.
    ``assets`` maps a name to the bytes ``GET``/``HEAD /assets/<name>``
    serve, as ``image/png`` unless ``asset_types`` names another type (the
    jobs' input images and clips)."""

    def __init__(self) -> None:
        import http.server
        import threading

        self.cond = threading.Condition()
        self.queued: list[dict] = []
        self.results: list[dict] = []
        self.result_t: list[float] = []
        self.faults: dict[str, list[int]] = {}
        self.assets: dict[str, bytes] = {}
        self.asset_types: dict[str, str] = {}  # image/png unless named
        self.work_t: list[float] = []  # when each poll that handed out work
        self.posts = 0
        hive = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass

            def _reply(self, status: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _asset(self, with_body: bool) -> bool:
                name = self.path.split("?")[0].removeprefix("/assets/")
                body = hive.assets.get(name)
                if not self.path.startswith("/assets/") or body is None:
                    return False
                self.send_response(200)
                self.send_header("Content-Type",
                                 hive.asset_types.get(name, "image/png"))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if with_body:
                    self.wfile.write(body)
                return True

            def do_HEAD(self) -> None:
                if not self._asset(with_body=False):
                    self.send_response(404)
                    self.end_headers()

            def do_GET(self) -> None:
                if self._asset(with_body=True):
                    return
                path = self.path.split("?")[0]
                if path == "/api/models":
                    return self._reply(200, {"models": []})
                if path != "/api/work":
                    return self._reply(404, {"message": "no such endpoint"})
                with hive.cond:
                    jobs, hive.queued = hive.queued, []
                    if jobs:
                        hive.work_t.append(time.perf_counter())
                self._reply(200, {"jobs": jobs})

            def do_POST(self) -> None:
                body = self.rfile.read(int(self.headers["Content-Length"]))
                result = json.loads(body)
                with hive.cond:
                    hive.posts += 1
                    statuses = hive.faults.get(str(result.get("id")))
                    status = statuses.pop(0) if statuses else 200
                    if status == 200:
                        hive.results.append(result)
                        hive.result_t.append(time.perf_counter())
                        hive.cond.notify_all()
                if status != 200:
                    return self._reply(status, {"message": "unavailable"})
                self._reply(200, {"status": "ok"})

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="local-hive", daemon=True)

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def submit(self, *jobs: dict) -> None:
        with self.cond:
            self.queued.extend(dict(job) for job in jobs)

    def __enter__(self) -> "LocalHive":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def serve_through_worker(hive: LocalHive, pool, registry, jobs: list[dict],
                         late=None, timeout_s: float = 600.0):
    """Queue ``jobs`` on ``hive``, run the port's ``Worker`` (its default
    settings but the hive address) until a result per job (and per job
    ``late`` submits) has arrived, then stop it. ``late(hive, t0)`` is
    awaited beside the worker. Returns the worker."""
    import asyncio

    from chiaswarm_tpu_torch.node.settings import Settings
    from chiaswarm_tpu_torch.node.worker import Worker

    hive.submit(*jobs)
    want = len(hive.results) + len(jobs) + (1 if late else 0)
    worker = Worker(Settings(hive_uri=hive.uri, hive_token="chip-smoke",
                             worker_name="chip-smoke"),
                    pool=pool, registry=registry)

    async def drive():
        task = asyncio.create_task(worker.run())
        extra = asyncio.create_task(late(hive)) if late else None
        t0 = time.perf_counter()
        try:
            while len(hive.results) < want:
                if task.done():
                    task.result()  # the worker died: raise its error
                    raise AssertionError("the worker stopped early")
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(
                        f"{len(hive.results)} of {want} results after "
                        f"{timeout_s} s")
                await asyncio.sleep(0.005)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=120)
            if extra is not None:
                await extra

    asyncio.run(drive())
    return worker


def trace_rows(worker) -> dict:
    """Per job id: its seconds from poll receipt to settled upload, its
    phases (poll = queue wait, execute, upload) and the spans under each
    (``execute.encode_s`` and so on; a span that repeats, such as an
    upload's attempts, sums), from the worker's trace ring."""
    return {trace.meta["id"]: span_rows(trace)
            for trace in worker.traces.traces()}


def span_rows(trace) -> dict:
    row = {"seconds": trace.root.duration_s}
    for phase in trace.root.children:
        row[f"{phase.name}_s"] = phase.duration_s
        for span in phase.children:
            key = f"{phase.name}.{span.name}_s"
            row[key] = row.get(key, 0.0) + span.duration_s
    return row


def host_breakdown(row: dict, generation_s: float) -> dict:
    """The worker's host seconds of one job (job seconds minus the
    executor's ``generation_s``, which runs from the lane submission's end
    to the decoded image) and the spans that make them up; ``other`` is
    what no span covers (thread hops, the executor around the spans)."""
    parts = {"poll": row.get("poll_s", 0.0),
             "format": row.get("execute.format_s", 0.0),
             "text_encode": row.get("execute.encode_s", 0.0),
             "png_base64": row.get("execute.artifacts_s", 0.0),
             "upload": row.get("upload_s", 0.0)}
    host_s = row["seconds"] - generation_s
    return {"host_s": host_s, **parts, "other": host_s - sum(parts.values())}


@contextlib.contextmanager
def lane_admissions(record: dict | None = None, hold: dict | None = None):
    """Watch or steer the lanes' admissions (``serving/stepper.py``,
    ``Lane._admit_locked``) while the block runs:

    - ``record`` fills with job id -> (lane id, lane step, slots) as each
      job is admitted;
    - ``hold`` maps job id -> lane step: nothing is admitted into a lane
      until every job it names has been submitted to that lane, and each is
      then held until the lane has executed that many steps. Jobs released
      at one step are admitted in their submission order, into the lowest
      free slots, as the lane always admits. A lane the guard condemns
      hands its jobs to a fresh lane, which waits for all of them again."""
    from chiaswarm_tpu_torch.serving.stepper import Lane

    admit = Lane._admit_locked
    submitted: dict = collections.defaultdict(set)  # by lane id

    def steered(lane) -> None:
        held: list = []
        if hold:
            seen = submitted[lane.lane_id]
            seen.update(job.job_id for job in lane._pending)
            if set(hold) - seen:
                return  # a job of the schedule is still being submitted
            held = [job for job in lane._pending
                    if hold.get(job.job_id, 0) > lane.steps_executed]
            lane._pending = collections.deque(
                job for job in lane._pending
                if not any(job is h for h in held))
        admit(lane)
        lane._pending.extend(held)
        if record is not None:
            for job in lane._rows:
                if job is not None and job.job_id not in record:
                    record[job.job_id] = (lane.lane_id, job.admitted_at_step,
                                          list(job.slots))

    Lane._admit_locked = steered
    try:
        yield
    finally:
        Lane._admit_locked = admit


def replay_burst(registry, slot, jobs: list[dict], admissions: dict) -> dict:
    """``jobs`` through ``synchronous_do_work_batch`` on a fresh lane of
    ``LANE_WIDTH`` rows, each admitted at the lane step at which
    ``admissions`` (from ``lane_admissions``) says it was: the same jobs
    in the same slots beside the same rows at every step. Returns the
    envelope by job id, the replay's admissions, its lane steps and its B1
    launches (0 on the CPU)."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL as B1
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    get_stepper(slot).shutdown()
    order = sorted(jobs, key=lambda j: admissions[j["id"]][1:])
    replayed: dict = {}
    with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)), lane_admissions(
            record=replayed,
            hold={j["id"]: admissions[j["id"]][1] for j in order}):
        before, b1_before = stepper_stats(slot), B1.launches
        results = synchronous_do_work_batch([dict(j) for j in order], slot,
                                            registry)
        steps = delta(stepper_stats(slot), before, "steps_executed")
        b1 = B1.launches - b1_before
    get_stepper(slot).shutdown()
    return {"results": {job["id"]: result
                        for job, result in zip(order, results)},
            "admissions": replayed, "steps": steps, "b1_launches": b1}


def worker_child(hive: LocalHive, root: Path) -> dict:
    """``python -m chiaswarm_tpu_torch.node.worker`` as a child process
    pointed at ``hive`` by ``SDAAS_URI``/``SDAAS_TOKEN``: its registry holds
    no checkpoint and no random fallback, so one ``sd15`` job must come back
    as a non-fatal ``model_unavailable`` envelope; then SIGTERM, and the
    child drains and exits with 0."""
    import signal

    job = dict(JOBS[0], id="worker-child-1")
    hive.submit(job)
    log_path = root / "child.log"
    child_env = dict(os.environ, SDAAS_URI=hive.uri, SDAAS_TOKEN="chip-smoke",
                     SDAAS_WORKERNAME="chip-smoke-child",
                     SWARM_TPU_ROOT=str(root / "child"))
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        child = subprocess.Popen(
            [sys.executable, "-m", "chiaswarm_tpu_torch.node.worker"],
            cwd=ROOT, env=child_env, stdout=log_file,
            stderr=subprocess.STDOUT)
        try:
            with hive.cond:
                if not hive.cond.wait_for(
                        lambda: any(r["id"] == job["id"]
                                    for r in hive.results), timeout=300):
                    raise AssertionError("the child worker uploaded nothing")
            result_s = time.perf_counter() - t0
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    text = log_path.read_text()
    startup = [line for line in text.splitlines()
               if "card(s)" in line or "derived default mesh" in line]
    [result] = [r for r in hive.results if r["id"] == job["id"]]
    cfg = result["pipeline_config"]
    out = {"rc": rc, "error_kind": cfg.get("error_kind"),
           "fatal_error": bool(result.get("fatal_error")),
           "result_after_s": result_s, "startup": startup,
           "log_tail": text.splitlines()[-5:]}
    if (rc != 0 or cfg.get("error_kind") != "model_unavailable"
            or result.get("fatal_error") or not startup):
        raise AssertionError(f"the child worker failed: {out}")
    return out


def worker_serve_phase(torch, registry, pool, lane_blobs: dict,
                       burst_blobs: dict, burst_ips: float,
                       ckpt: dict, image_blobs: dict) -> dict:
    """The port's ``Worker.run()`` against a hive served from this script
    (``LocalHive``), on the lanes, on the serve phases' ``ChipPool``:

    - the lone job: ``serve``'s seed-1 job in a fresh lane at the lanes'
      default width; error-free with a 512x512 PNG and a ``stepper``
      stamp, and bit for bit ``lane_serve``'s seed-1 image (the same lane
      of 2 rows). Then, in the warm lane, twice: the same job through
      ``synchronous_do_work`` (with a trace of its own), then through the
      worker; each pair bit for bit, and their seconds side by side;
    - the burst: ``lane_burst``'s jobs at its pinned width of 8, seeds
      11-18 handed out by the first poll that returns work and seed 19 by a
      later one once the lane has stepped 5 times; all nine arrive once,
      each bit for bit the image of ``replay_burst`` (the same jobs in the
      same slots at the same lane steps), which runs last; the difference
      from ``lane_burst``'s image of each seed is printed;
    - one upload fault: the first POST of a re-run of the lone job gets a
      503; ``upload_retries`` rises by 1 and the result arrives once, with
      the lone job's image;
    - the checkpoint model: ``CKPT_MODEL``'s seed-1 job, served by a worker
      whose registry has no random fallback and loads the model from disk
      (the settings root of ``checkpoint_serve``): an error-free PNG, bit
      for bit ``checkpoint_serve``'s seed-1 image (a fresh lane both times);
    - image jobs: ``IMG_JOBS[0]`` (img2img) and ``INPAINT_JOBS[0]``
      (inpaint), their images fetched from the hive by URI, each alone in a
      fresh lane: error-free 512x512 PNGs, bit for bit the lane image of
      the same job in ``img2img_serve`` and ``inpaint_serve``
      (``image_blobs``, by seed); then one job whose init image is past the
      3 MiB input cap: a non-fatal ``bad_asset`` envelope;
    - the entry point: ``python -m chiaswarm_tpu_torch.node.worker`` as a
      child process (``worker_child``).

    B1 launches 10 times per lane step, at held shapes. Prints each job's
    seconds (poll receipt to settled upload, from the worker's traces and
    its ``chiaswarm_job_seconds`` histogram) and spans, the worker's host
    seconds (``host_breakdown``), the burst's images/s from the first poll
    that returned work to the last upload beside ``lane_burst``'s, and the
    lane steps and occupancy. Returns the launches of the worker's runs
    (``launched``), the replay's excluded."""
    import tempfile

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.obs import trace as obs_trace
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL as B1
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    slot = pool.slots[0]
    get_stepper(slot).shutdown()
    out: dict = {}
    failed: list[str] = []  # checked after every sub-run has run
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="worker-serve-") as tmp, \
            env(SWARM_TPU_ROOT=tmp), LocalHive() as hive:
        hive.assets.update(image_assets())
        # the lone job, in a fresh lane
        before, b1_before = stepper_stats(slot), B1.launches
        lone_job = dict(JOBS[0], id="worker-sd15-1")
        worker = serve_through_worker(hive, pool, registry, [lone_job])
        [lone] = [r for r in hive.results if r["id"] == lone_job["id"]]
        lone_blob = check_envelope("worker_serve", lone_job, lone, lanes=True)
        steps = delta(stepper_stats(slot), before, "steps_executed")
        rows = trace_rows(worker)[lone_job["id"]]
        gen_s = lone["pipeline_config"]["generation_s"]
        out["lone"] = {
            **rows, "generation_s": gen_s,
            **host_breakdown(rows, gen_s),
            "histogram_count": worker._job_seconds.count(),
            "histogram_sum_s": worker._job_seconds.sum(),
            "steps_executed": steps,
            "b1_launches": B1.launches - b1_before,
            "stepper": lone["pipeline_config"]["stepper"],
            "vs_lane_serve": image_diffs({1: lone_blob},
                                         {1: lane_blobs[1]})[1]}
        emit("worker_serve_lone", **out["lone"])
        if (B1.launches - b1_before != steps * B1_LAUNCHES_PER_UNET_EVAL
                or not out["lone"]["vs_lane_serve"]["bit_equal"]):
            raise AssertionError(f"worker_serve lone job: {out['lone']}")

        # the same job in the warm lane: the executor alone, then the worker
        warm = []
        for turn in range(2):
            direct_job = dict(JOBS[0], id=f"direct-sd15-1-{turn}")
            trace = obs_trace.JobTrace(id=direct_job["id"])
            obs_trace.attach(direct_job, trace)
            trace.phase("execute")
            direct = synchronous_do_work(direct_job, slot, registry)
            trace.finish(obs_trace.TraceRing())
            direct_blob = check_envelope("worker_serve", direct_job, direct,
                                         lanes=True)
            job = dict(JOBS[0], id=f"worker-sd15-1-{turn}")
            worker = serve_through_worker(hive, pool, registry, [job])
            [result] = [r for r in hive.results if r["id"] == job["id"]]
            blob = check_envelope("worker_serve", job, result, lanes=True)
            rows = trace_rows(worker)[job["id"]]
            d_rows = span_rows(trace)
            gen_s = result["pipeline_config"]["generation_s"]
            d_gen_s = direct["pipeline_config"]["generation_s"]
            warm.append({
                "direct": {**d_rows, "generation_s": d_gen_s,
                           **host_breakdown(d_rows, d_gen_s)},
                "worker": {**rows, "generation_s": gen_s,
                           **host_breakdown(rows, gen_s)},
                "worker_minus_direct_s": rows["seconds"] - d_rows["seconds"],
                "lane_widths": [direct["pipeline_config"]["stepper"]
                                ["lane_width"],
                                result["pipeline_config"]["stepper"]
                                ["lane_width"]],
                "bit_equal": blob == direct_blob})
        get_stepper(slot).shutdown()
        out["warm"] = warm
        emit("worker_serve_warm", turns=warm,
             mean_worker_minus_direct_s=statistics.mean(
                 t["worker_minus_direct_s"] for t in warm))
        if not all(t["bit_equal"] for t in warm):
            failed.append(f"worker_serve warm lone jobs: {warm}")

        # the burst, at lane_burst's pinned width
        admissions: dict = {}
        with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)), \
                lane_admissions(record=admissions):
            before, b1_before = stepper_stats(slot), B1.launches
            late_at: dict = {}

            async def late(hive_):
                import asyncio

                while (delta(stepper_stats(slot), before, "steps_executed")
                       < 5):
                    await asyncio.sleep(0.002)
                late_at["step"] = delta(stepper_stats(slot), before,
                                        "steps_executed")
                late_at["polls_with_work"] = len(hive_.work_t)
                hive_.submit(LATE_JOB)

            first_poll = len(hive.work_t)
            first_result = len(hive.results)
            worker = serve_through_worker(hive, pool, registry,
                                          BURST_JOBS, late=late)
            after = stepper_stats(slot)
            get_stepper(slot).shutdown()
        results = hive.results[first_result:]
        t_first_work = hive.work_t[first_poll]
        t_last = hive.result_t[-1]
        ids = [r["id"] for r in results]
        jobs = BURST_JOBS + [LATE_JOB]
        if sorted(ids) != sorted(j["id"] for j in jobs):
            raise AssertionError(f"worker_serve burst results: {ids}")
        by_id = {r["id"]: r for r in results}
        blobs, infos, host = {}, {}, []
        traces = trace_rows(worker)
        for job in jobs:
            result = by_id[job["id"]]
            blobs[job["seed"]] = check_envelope("worker_serve", job, result,
                                                lanes=True)
            infos[job["seed"]] = result["pipeline_config"]["stepper"]
            host.append(host_breakdown(
                traces[job["id"]], result["pipeline_config"]["generation_s"]))
        steps = delta(after, before, "steps_executed")
        row_active = delta(after, before, "row_steps_active")
        row_padded = delta(after, before, "row_steps_padded")
        diffs = image_diffs(blobs, burst_blobs)
        wall_s = t_last - t_first_work
        out["burst"] = {
            "jobs": len(jobs), "lane_width": LANE_WIDTH,
            "wall_s": wall_s, "images_per_s": len(jobs) / wall_s,
            "lane_burst_images_per_s": burst_ips,
            "vs_lane_burst_images_per_s": len(jobs) / wall_s / burst_ips,
            "late_submitted_at_step": late_at.get("step"),
            "late_polls_with_work_before": late_at.get("polls_with_work"),
            "polls_with_work": len(hive.work_t) - first_poll,
            "late_admitted_at_step": infos[19]["admitted_at_step"],
            "steps_executed": steps,
            "row_steps_active": row_active, "row_steps_padded": row_padded,
            "occupancy": row_active / max(1, row_active + row_padded),
            "b1_launches": B1.launches - b1_before,
            "job_seconds": {j["id"]: traces[j["id"]] for j in jobs},
            "generation_s": {
                j["id"]: by_id[j["id"]]["pipeline_config"]["generation_s"]
                for j in jobs},
            "host_per_job": host,
            "mean_host_s": statistics.mean(h["host_s"] for h in host),
            "histogram_count": worker._job_seconds.count(),
            "histogram_sum_s": worker._job_seconds.sum(),
            "lanes": sorted({info["lane"] for info in infos.values()}),
            "admissions": {j["seed"]: admissions.get(j["id"]) for j in jobs},
            "vs_lane_burst": diffs,
            "bit_equal_vs_lane_burst": sum(d["bit_equal"]
                                           for d in diffs.values()),
            "within_one_level_of_lane_burst": sum(
                d["max"] <= 1 for d in diffs.values())}
        emit("worker_serve_burst", **out["burst"])
        if (B1.launches - b1_before != steps * B1_LAUNCHES_PER_UNET_EVAL
                or len(out["burst"]["lanes"]) != 1
                or any(j["id"] not in admissions for j in jobs)):
            failed.append(f"worker_serve burst: {out['burst']}")

        # one upload fault on a re-run of the lone job
        retry_job = dict(JOBS[0], id="worker-sd15-retry-1")
        hive.faults[retry_job["id"]] = [503]
        posts_before = hive.posts
        worker = serve_through_worker(hive, pool, registry, [retry_job])
        get_stepper(slot).shutdown()
        arrived = [r for r in hive.results if r["id"] == retry_job["id"]]
        retry_blob = check_envelope("worker_serve", retry_job, arrived[0],
                                    lanes=True)
        out["upload_fault"] = {
            "upload_retries": worker.stats.upload_retries,
            "posts": hive.posts - posts_before, "arrived": len(arrived),
            "seconds": trace_rows(worker)[retry_job["id"]],
            "bit_equal_to_lone": retry_blob == lone_blob}
        emit("worker_serve_upload_fault", **out["upload_fault"])
        if (worker.stats.upload_retries != 1 or len(arrived) != 1
                or hive.posts - posts_before != 2 or retry_blob != lone_blob):
            failed.append(f"worker_serve upload fault: "
                          f"{out['upload_fault']}")

        # the checkpoint model, loaded from disk by the worker's registry
        ck_job = dict(CKPT_JOBS[0], id="worker-ckpt-sd15-1")
        with env(SWARM_TPU_ROOT=str(settings_root_dir())):
            ck_registry = ModelRegistry(
                catalog=[{"name": CKPT_MODEL, "family": "sd15"}],
                device="cuda")
            before, b1_before = stepper_stats(slot), B1.launches
            worker = serve_through_worker(hive, pool, ck_registry, [ck_job])
            ck_steps = delta(stepper_stats(slot), before, "steps_executed")
            get_stepper(slot).shutdown()
        [ck_result] = [r for r in hive.results if r["id"] == ck_job["id"]]
        ck_blob = check_envelope("worker_serve", ck_job, ck_result, lanes=True)
        out["checkpoint"] = {
            "seconds": trace_rows(worker)[ck_job["id"]],
            "generation_s": ck_result["pipeline_config"]["generation_s"],
            "steps_executed": ck_steps,
            "b1_launches": B1.launches - b1_before,
            "residency": ck_registry.residency.snapshot(),
            "vs_checkpoint_serve": image_diffs(
                {1: ck_blob}, {1: ckpt["blobs"][1]})[1]}
        del ck_registry
        emit("worker_serve_checkpoint", **out["checkpoint"])
        if (out["checkpoint"]["b1_launches"]
                != ck_steps * B1_LAUNCHES_PER_UNET_EVAL
                or not out["checkpoint"]["vs_checkpoint_serve"]["bit_equal"]):
            failed.append(f"worker_serve checkpoint job: {out['checkpoint']}")

        # image jobs fetched by URI, each alone in a fresh lane
        out["image_jobs"] = {}
        for job in on_hive(hive, [dict(IMG_JOBS[0], id="worker-img2img-31"),
                                  dict(INPAINT_JOBS[0],
                                       id="worker-inpaint-41")]):
            get_stepper(slot).shutdown()
            before, b1_before = stepper_stats(slot), B1.launches
            worker = serve_through_worker(hive, pool, registry, [job])
            image_steps = delta(stepper_stats(slot), before,
                                "steps_executed")
            get_stepper(slot).shutdown()
            [result] = [r for r in hive.results if r["id"] == job["id"]]
            blob = check_envelope("worker_serve", job, result, lanes=True)
            cfg = result["pipeline_config"]
            row = {"mode": cfg["mode"], "denoise_steps": cfg["denoise_steps"],
                   "seconds": trace_rows(worker)[job["id"]],
                   "generation_s": cfg["generation_s"],
                   "steps_executed": image_steps,
                   "b1_launches": B1.launches - b1_before,
                   "vs_lane_image": image_diffs(
                       {job["seed"]: blob},
                       {job["seed"]: image_blobs[job["seed"]]})[job["seed"]]}
            out["image_jobs"][job["id"]] = row
            emit("worker_serve_image_job", id=job["id"], **row)
            if (row["b1_launches"] != image_steps * B1_LAUNCHES_PER_UNET_EVAL
                    or not row["vs_lane_image"]["bit_equal"]):
                failed.append(f"worker_serve image job {job['id']}: {row}")

        # an init image past the input cap: a non-fatal bad_asset envelope
        [bad_job] = on_hive(hive, [dict(IMG_JOBS[0], id="worker-bad-asset",
                                        start_image_uri="/assets/"
                                        "oversized.png")])
        serve_through_worker(hive, pool, registry, [bad_job])
        [bad] = [r for r in hive.results if r["id"] == bad_job["id"]]
        out["bad_asset"] = {
            "error_kind": bad["pipeline_config"].get("error_kind"),
            "fatal_error": bool(bad.get("fatal_error")),
            "error": bad["pipeline_config"].get("error")}
        emit("worker_serve_bad_asset", **out["bad_asset"])
        if (out["bad_asset"]["error_kind"] != "bad_asset"
                or out["bad_asset"]["fatal_error"]):
            failed.append(f"worker_serve bad asset: {out['bad_asset']}")

        # the entry point, as a node operator starts it
        out["child"] = worker_child(hive, Path(tmp))
        emit("worker_serve_child", **out["child"])
    run = launched()

    # the burst's batch composition again, outside the worker: each image
    # bit for bit the worker's
    if not failed:
        replay = replay_burst(registry, slot, jobs, admissions)
        exact = image_diffs(blobs, {
            job["seed"]: check_envelope("worker_serve", job,
                                        replay["results"][job["id"]],
                                        lanes=True) for job in jobs})
        out["replay"] = {
            "steps_executed": replay["steps"],
            "b1_launches": replay["b1_launches"],
            # (lane step, slots) of each job; the lane is a fresh one
            "same_admissions": {k: v[1:] for k, v in
                                replay["admissions"].items()}
            == {k: v[1:] for k, v in admissions.items()},
            "bit_equal": sum(d["bit_equal"] for d in exact.values()),
            "vs_worker": exact}
        emit("worker_serve_replay", **out["replay"])
        if (not out["replay"]["same_admissions"]
                or out["replay"]["bit_equal"] != len(jobs)
                or replay["steps"] != steps
                or replay["b1_launches"]
                != steps * B1_LAUNCHES_PER_UNET_EVAL):
            failed.append(f"worker_serve replay: {out['replay']} "
                          f"(worker admissions {admissions})")
    emit("worker_serve", lone_seconds=out["lone"]["seconds"],
         lone_host_s=out["lone"]["host_s"],
         warm_worker_minus_direct_s=[t["worker_minus_direct_s"]
                                     for t in out["warm"]],
         burst_images_per_s=out["burst"]["images_per_s"],
         lane_burst_images_per_s=burst_ips,
         burst_mean_host_s=out["burst"]["mean_host_s"],
         burst_bit_equal_vs_replay=out.get("replay", {}).get("bit_equal"),
         burst_within_one_level_of_lane_burst=out["burst"][
             "within_one_level_of_lane_burst"],
         checkpoint_job_bit_equal=out["checkpoint"]["vs_checkpoint_serve"][
             "bit_equal"],
         image_jobs_bit_equal={k: v["vs_lane_image"]["bit_equal"]
                               for k, v in out["image_jobs"].items()},
         bad_asset_kind=out["bad_asset"]["error_kind"],
         b1_launches=run["flash_attention"]["launches"])
    if failed:
        raise AssertionError("; ".join(failed))
    return run


def solo_pair_phase(torch, registry, slot, lane_blob: str,
                    solo_blob: str) -> dict:
    """Seed 1 with ``num_images_per_prompt=2`` on the solo path (a CFG
    batch of 4 rows, the UNet batch of a lane of 2) and through a lane
    pinned at 2 rows (the same UNet batch, text batch and noise): the two
    grids bit for bit, which holds the lane's per-row step to the solo
    step on the card. The solo pair's first image (the left half of its
    1x2 grid) is also set beside the lone job's lane image (a lane of 2
    with a padding row; its text encoded alone) and beside the solo path's
    one-image render (a CFG batch of 2)."""
    import numpy as np

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    kernels.reset_launches()
    job = dict(JOBS[0], id="solo-pair-1", num_images_per_prompt=2)
    grids = {}
    for mode in ("0", "1"):
        with env(CHIASWARM_STEPPER=mode, CHIASWARM_STEPPER_LANE_WIDTH="2"):
            result = synchronous_do_work(dict(job), slot, registry)
        cfg = result["pipeline_config"]
        if "error" in cfg or ("stepper" in cfg) != (mode == "1"):
            raise AssertionError(f"solo_pair ({mode}): {cfg}")
        grids[mode] = decode_png(result["artifacts"]["primary"]["blob"])
        if grids[mode].shape != (512, 1024, 3):
            raise AssertionError(f"solo_pair grid is {grids[mode].shape}")
    get_stepper(slot).shutdown()
    row0 = grids["0"][:, :512]

    def diff(a, b):
        d = np.abs(a - b)
        return {"max": int(d.max()), "within_one": float((d <= 1).mean()),
                "bit_equal": bool((d == 0).all())}

    run = launched()
    pair = diff(grids["1"], grids["0"])
    emit("solo_pair", lane_pair_vs_solo_pair=pair,
         solo_pair_row_0_vs_lone_lane_job=diff(row0, decode_png(lane_blob)),
         solo_pair_row_0_vs_solo_1=diff(row0, decode_png(solo_blob)),
         b1_shapes=[[*k, n] for k, n in run["flash_attention"]["shapes"]
                    .items()])
    if not pair["bit_equal"]:
        raise AssertionError(f"solo_pair: the lane's pair is not the solo "
                             f"pair bit for bit: {pair}")
    return run


# ---- img2img and inpaint ------------------------------------------------

IMG_SIZE = 512
# strength -> start index 5, 10 and 14 of 20: 15, 10 and 6 UNet evals
IMG_STRENGTHS = {31: 0.75, 32: 0.5, 33: 0.3}
IMG_JOBS = [dict(JOBS[0], id=f"img2img-sd15-{seed}", seed=seed,
                 prompt="the same scene as a watercolor", strength=strength,
                 start_image_uri=f"/assets/init-{seed}.png")
            for seed, strength in IMG_STRENGTHS.items()]
INPAINT_JOBS = [dict(JOBS[0], id=f"inpaint-sd15-{seed}", seed=seed,
                     prompt="a red door", start_image_uri=f"/assets/"
                     f"init-{seed}.png", mask_image_uri="/assets/mask.png")
                for seed in (41, 42)]


def smooth_image(seed: int, size: int):
    """A smooth uint8 (size, size, 3) test picture made from ``seed``: a few
    low-frequency waves per channel and three flat rectangles (a PNG of it
    stays far under the 3 MiB input cap at 1024 px)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            img[..., c] += rng.uniform(0.2, 1.0) * np.sin(
                2 * np.pi * (fx * x + fy * y) + rng.uniform(0, 2 * np.pi))
    for _ in range(3):
        y0, x0 = rng.integers(0, size * 3 // 4, 2)
        h, w = rng.integers(size // 8, size // 3, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.uniform(-2, 2, 3)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def rect_mask(size: int):
    """The inpaint mask: 255 (regenerate) in a rectangle, 0 elsewhere."""
    import numpy as np

    mask = np.zeros((size, size), np.uint8)
    mask[size // 4: size * 5 // 8, size * 3 // 8: size * 7 // 8] = 255
    return mask


def png_bytes(pixels) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    return buf.getvalue()


def image_assets() -> dict:
    """Every input the image phases fetch, by asset name: the init images
    of IMG_JOBS, INPAINT_JOBS and XL_IMG_JOB, the mask, and one body past
    the 3 MiB input cap."""
    from chiaswarm_tpu_torch.node.job_args import MAX_IMAGE_BYTES

    assets = {f"init-{seed}.png": png_bytes(smooth_image(seed, IMG_SIZE))
              for seed in (*IMG_STRENGTHS, 41, 42)}
    assets["init-51-1024.png"] = png_bytes(smooth_image(51, XL_SIZE))
    assets["mask.png"] = png_bytes(rect_mask(IMG_SIZE))
    assets["oversized.png"] = b"\x89PNG" + bytes(MAX_IMAGE_BYTES)
    return assets


def on_hive(hive: LocalHive, jobs: list[dict]) -> list[dict]:
    """``jobs`` with their asset paths as URIs on ``hive``."""
    out = []
    for job in jobs:
        job = dict(job)
        for key in ("start_image_uri", "mask_image_uri"):
            if key in job:
                job[key] = hive.uri + job[key]
        out.append(job)
    return out


@contextlib.contextmanager
def watch_pipe(torch, pipe):
    """Records, for the block, each init-image encode of ``pipe`` (its
    latents and the CUDA-event ms around the whole call on the current
    stream: the host's conversion, posterior draw and upload inside, as the
    job pays them) and the latents of each VAE decode (solo and lanes)."""
    rec = {"encodes": [], "final": []}
    encode, decode = pipe.encode_init_image, pipe._decode_uint8

    def timed_encode(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        z = encode(*args, **kw)
        end.record()
        rec["encodes"].append((z, start, end))
        return z

    def kept_decode(x):
        rec["final"].append(x.clone())
        return decode(x)

    pipe.encode_init_image, pipe._decode_uint8 = timed_encode, kept_decode
    try:
        yield rec
    finally:
        del pipe.encode_init_image, pipe._decode_uint8
        torch.cuda.synchronize()
        rec["encode_ms"] = [s.elapsed_time(e) for _, s, e in rec["encodes"]]


def encode_shares(rec: dict, configs: list) -> list:
    """Each job's encode call (event ms, host work inside) over its
    ``generation_s``."""
    return [ms / 1e3 / cfg["generation_s"]
            for ms, cfg in zip(rec["encode_ms"], configs)]


def check_b1(phase: str, launches: dict, want: int) -> None:
    if launches["flash_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"{phase} launched {launches}, expected {want} "
                             "of flash_attention and no other")


def kernel_launches() -> dict:
    from chiaswarm_tpu_torch.ops import kernels

    return {name: k.launches for name, k in kernels.KERNELS.items()}


def image_solo_and_lanes(torch, phase: str, registry, slot, jobs: list,
                         per_eval: int, model: str = "sd15") -> dict:
    """``jobs`` on the solo path (``CHIASWARM_STEPPER=0``), then one after
    another through the lanes: error-free envelopes with PNGs of the jobs'
    size, B1 exactly ``per_eval`` x UNet evals (solo: the configs'
    ``unet_evals``; lanes: lane steps) and no other kernel. Prints each
    job's seconds, ``generation_s`` and the encode's device ms and share of
    it. Returns both runs' launches, blobs, configs and watch records."""
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    pipe = registry.pipeline(model)
    out = {}
    for mode, lanes in (("solo", False), ("lanes", True)):
        configs: list = []
        get_stepper(slot).shutdown()
        before = stepper_stats(slot)
        with env(CHIASWARM_STEPPER="1" if lanes else "0"), \
                watch_pipe(torch, pipe) as rec:
            seconds, blobs = run_jobs(torch, f"{phase}_{mode}", slot,
                                      registry, lanes=lanes, jobs=jobs,
                                      configs=configs)
            launches, run = kernel_launches(), launched()
        steps = delta(stepper_stats(slot), before, "steps_executed")
        get_stepper(slot).shutdown()
        evals = steps if lanes else sum(c["unet_evals"] for c in configs)
        emit(f"{phase}_{mode}", jobs=len(jobs), job_seconds=seconds,
             generation_s=[c["generation_s"] for c in configs],
             denoise_steps=[c["denoise_steps"] for c in configs],
             modes=[c["mode"] for c in configs],
             encode_ms=rec["encode_ms"],
             encode_share_of_generation=encode_shares(rec, configs),
             unet_evals=evals, lane_steps=steps if lanes else None,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             launches=launches, expected_flash_launches=per_eval * evals)
        check_b1(f"{phase}_{mode}", launches, per_eval * evals)
        if len(rec["encodes"]) != len(jobs):
            raise AssertionError(f"{phase}_{mode}: {len(rec['encodes'])} "
                                 f"encodes for {len(jobs)} jobs")
        out[mode] = {"run": run, "blobs": blobs, "configs": configs,
                     "rec": rec, "seconds": seconds}
    return out


def img2img_serve_phase(torch, registry, slot, hive: LocalHive) -> tuple:
    """SD1.5 at 512 px, 20 steps: three img2img jobs at strengths 0.75, 0.5
    and 0.3 (start indices 5, 10 and 14), their init images fetched from
    this script's hive, solo then in lanes (``image_solo_and_lanes``: B1 =
    10 x (15 + 10 + 6) solo). Then ``solo_pair``'s composition for img2img:
    seed 31 with two images on the solo path and through a lane pinned at 2
    rows, bit for bit. Returns the runs and the solo and lane blobs."""
    import numpy as np

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.diffusion import img2img_start_index
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    jobs = on_hive(hive, IMG_JOBS)
    out = image_solo_and_lanes(torch, "img2img_serve", registry, slot, jobs,
                               B1_LAUNCHES_PER_UNET_EVAL)
    starts = [img2img_start_index(SERVE_STEPS, s)
              for s in IMG_STRENGTHS.values()]
    got = [SERVE_STEPS - c["denoise_steps"] for c in out["solo"]["configs"]]
    if starts != [5, 10, 14] or got != starts:
        raise AssertionError(f"img2img start indices {got}, expected "
                             f"{starts} = [5, 10, 14]")

    kernels.reset_launches()
    job = dict(jobs[0], id="img2img-pair-31", num_images_per_prompt=2)
    grids = {}
    for mode in ("0", "1"):
        with env(CHIASWARM_STEPPER=mode, CHIASWARM_STEPPER_LANE_WIDTH="2"):
            result = synchronous_do_work(dict(job), slot, registry)
        cfg = result["pipeline_config"]
        if "error" in cfg or ("stepper" in cfg) != (mode == "1"):
            raise AssertionError(f"img2img pair ({mode}): {cfg}")
        grids[mode] = decode_png(result["artifacts"]["primary"]["blob"])
    get_stepper(slot).shutdown()
    pair_run = launched()
    d = np.abs(grids["1"] - grids["0"])
    pair = {"max": int(d.max()), "bit_equal": bool((d == 0).all()),
            "shape": list(grids["0"].shape)}
    emit("img2img_serve", strengths=list(IMG_STRENGTHS.values()),
         start_indices=starts,
         solo_job_seconds=out["solo"]["seconds"],
         lane_job_seconds=out["lanes"]["seconds"],
         lanes_vs_solo=image_diffs(out["lanes"]["blobs"],
                                   out["solo"]["blobs"]),
         pair_lane_vs_solo=pair,
         pair_b1_shapes=[[*k, n] for k, n in
                         pair_run["flash_attention"]["shapes"].items()])
    if not pair["bit_equal"] or pair["shape"] != [IMG_SIZE, 2 * IMG_SIZE, 3]:
        raise AssertionError(f"img2img pair: the lane's pair is not the solo "
                             f"pair bit for bit: {pair}")
    return ({"img2img_serve": out["solo"]["run"],
             "img2img_lane_serve": out["lanes"]["run"],
             "img2img_pair": pair_run},
            out["solo"]["blobs"], out["lanes"]["blobs"])


def inpaint_serve_phase(torch, registry, slot, hive: LocalHive) -> tuple:
    """Two inpaint jobs (a rectangular mask) on the solo path, then in
    lanes (``image_solo_and_lanes``: B1 = 10 x 20 a job solo). Each job's
    final latents equal its encoded init latents exactly where the latent
    mask keeps them (the last step's sigma is 0); the kept pixels of each
    image lie within the source's own VAE round-trip error (mean absolute
    uint8 error at most 1.5x that error + 2 levels), both printed. Returns
    the runs and the lane blobs."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.diffusion import latent_mask

    jobs = on_hive(hive, INPAINT_JOBS)
    out = image_solo_and_lanes(torch, "inpaint_serve", registry, slot, jobs,
                               B1_LAUNCHES_PER_UNET_EVAL)
    pipe = registry.pipeline("sd15")
    f = pipe.c.family.vae.downscale
    lh = IMG_SIZE // f
    kept = latent_mask(rect_mask(IMG_SIZE) / 255.0, lh, lh, f) == 0
    kept_px = np.kron(kept, np.ones((f, f), bool))
    kept_t = torch.from_numpy(kept).to(pipe.c.device)
    report, failed = {}, []
    for mode, res in out.items():
        for i, job in enumerate(jobs):
            known = res["rec"]["encodes"][i][0]
            final = res["rec"]["final"][i][:1]
            exact = bool(torch.equal(final[:, :, kept_t],
                                     known[:, :, kept_t]))
            with torch.inference_mode():
                rt = pipe._decode_uint8(known)[0].cpu().numpy().astype(
                    "int16")
            src = smooth_image(job["seed"], IMG_SIZE).astype("int16")
            img = decode_png(res["blobs"][job["seed"]])
            row = {
                "kept_latents_equal_known": exact,
                "kept_latent_share": float(kept.mean()),
                "round_trip_err_kept": float(np.abs(rt - src)[kept_px].mean()),
                "out_err_kept": float(np.abs(img - src)[kept_px].mean()),
                "out_vs_round_trip_kept": float(
                    np.abs(img - rt)[kept_px].mean()),
                "out_vs_round_trip_masked": float(
                    np.abs(img - rt)[~kept_px].mean())}
            report[f"{mode}_{job['seed']}"] = row
            if not exact or row["out_err_kept"] > (
                    1.5 * row["round_trip_err_kept"] + 2):
                failed.append(f"{mode} {job['id']}: {row}")
    emit("inpaint_serve", jobs=len(jobs), kept=report,
         lanes_vs_solo=image_diffs(out["lanes"]["blobs"],
                                   out["solo"]["blobs"]))
    if failed:
        raise AssertionError("inpaint_serve: " + "; ".join(failed))
    return {"inpaint_serve": out["solo"]["run"],
            "inpaint_lane_serve": out["lanes"]["run"]}, out["lanes"]["blobs"]


def seq_img2img_phase(torch, hive: LocalHive, solo_blob: str) -> dict:
    """IMG_JOBS' first job (strength 0.75: 15 UNet evals) on the solo path
    of the one-card ``seq = 4`` slot: B3 exactly 10 x 15 + 1 (the VAE
    decode's ring) and no other kernel, so the init image's encode ran
    outside the ring (its mid-block attention would add a B3 launch). The
    difference from img2img_serve's solo image is printed."""
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.mesh import MeshSpec
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(mesh_spec=MeshSpec({"seq": RING_SHARDS}),
                    devices=one_card_devices(torch)).slots[0]
    [job] = on_hive(hive, IMG_JOBS[:1])
    configs: list = []
    with env(CHIASWARM_RING_FLASH="", CHIASWARM_STEPPER="0"):
        load_pipeline(torch, "seq_img2img", registry, mesh=slot.mesh)
        with watch_pipe(torch, registry.pipeline("sd15", mesh=slot.mesh)) \
                as rec:
            seconds, blobs = run_jobs(torch, "seq_img2img", slot, registry,
                                      jobs=[job], configs=configs)
            launches, run = kernel_launches(), launched()
    evals = configs[0]["unet_evals"]
    want = evals * B3_LAUNCHES_PER_UNET_EVAL + B3_LAUNCHES_PER_DECODE
    emit("seq_img2img", job_seconds=seconds,
         generation_s=configs[0]["generation_s"], unet_evals=evals,
         encode_ms=rec["encode_ms"],
         encode_share_of_generation=encode_shares(rec, configs),
         mesh_shape=slot.descriptor()["mesh_shape"], launches=launches,
         expected_ring_launches=want,
         vs_img2img_serve=image_diffs(blobs, {job["seed"]: solo_blob}))
    if launches[B3.name] != want or sum(launches.values()) != want:
        raise AssertionError(f"seq_img2img launched {launches}, expected "
                             f"{want} of {B3.name} and no other")
    return run


# ---- SDXL at 1024 px ------------------------------------------------------

XL_MODEL = "sdxl"  # random weights from seed 0 (the registry's fallback)
XL_CKPT_MODEL = "stabilityai/stable-diffusion-xl-base-1.0"
XL_SIZE = 1024
XL_JOBS = [dict(job, id=f"smoke-sdxl-{job['seed']}", model_name=XL_MODEL,
                height=XL_SIZE, width=XL_SIZE) for job in JOBS]
# guidance 1.0: no CFG, so no lane (the solo path at UNet batch 1)
XL_NOCFG_JOB = dict(XL_JOBS[0], id="smoke-sdxl-nocfg-4", seed=4,
                    guidance_scale=1.0)
XL_LANE_WIDTH = 4
XL_BURST_JOBS = [dict(XL_JOBS[0], id=f"burst-sdxl-{seed}", seed=seed,
                      negative_prompt="blurry, low quality" if seed == 12
                      else "") for seed in range(11, 15)]


def xl_check_phase(torch) -> None:
    """The full-width SDXL UNet (2.57 B parameters, random from a seed) in
    bf16 at a 128x128 latent, the 1024 px serve shape: one eval through B1
    (70 launches: 10 at 4096 tokens, 60 at 1024) against one through the
    plain ``xla`` route, within relative L2 3e-2. Then the same weights in
    float32 at a 64x64 latent, TF32 off: within 1e-4, with 10 B1 launches
    (its 1024-token level; the 256-token level stays plain)."""
    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    cfg = FAMILIES["sdxl"].unet
    with torch.device("meta"):
        unet = UNet(cfg)
    unet = unet.to_empty(device="cuda").eval().requires_grad_(False)
    flax_default_init(unet, torch.Generator(device="cuda").manual_seed(0))
    cast_module(unet, torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(1)
    t = torch.tensor([999.0, 10.5], device="cuda")
    ctx = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen).cuda()
    added = {"time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                                      device="cuda"),
             "text_embeds": torch.randn((2, cfg.addition_pooled_dim),
                                        generator=gen).cuda()}
    results = []
    for dtype, side, tol, want in ((torch.bfloat16, 128, 3e-2, 70),
                                   (torch.float32, 64, 1e-4, 10)):
        cast_module(unet, dtype)  # bf16 -> float32 keeps every value
        x = torch.randn((2, 4, side, side), generator=gen).cuda().to(dtype)
        with torch.inference_mode():
            set_attn_impl(unet, "auto")
            before = KERNEL.launches
            out_kernel = unet(x, t, ctx.to(dtype), added).float()
            launches = KERNEL.launches - before
            set_attn_impl(unet, "xla")
            out_plain = unet(x, t, ctx.to(dtype), added).float()
            set_attn_impl(unet, "auto")
        torch.cuda.synchronize()
        rel = ((out_kernel - out_plain).norm() / out_plain.norm()).item()
        finite = bool(torch.isfinite(out_kernel).all())
        row = {"model": f"sdxl unet {str(dtype).removeprefix('torch.')}",
               "latent": list(x.shape), "b1_launches": launches,
               "rel_l2": rel, "finite": finite, "tolerance": tol,
               "design": design(str(dtype).removeprefix("torch."), 64)}
        emit("xl_check", **row)
        results.append(row)
        del out_kernel, out_plain
        if launches != want or not finite or not rel <= tol:
            raise AssertionError(f"SDXL UNet kernel route check failed: {row} "
                                 f"(want {want} launches)")
    del unet
    torch.cuda.empty_cache()


def xl_tokenizers():
    """The CLIP BPE tokenizer over ``synthetic_clip_vocab``, written to the
    checkpoint directory's ``tokenizer/`` (read later by the checkpoint
    load), one per text tower as the JAX package loads it: the random-weight
    SDXL phases and the checkpoint then give the same ids."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.models.tokenizer import load_tokenizer
    from chiaswarm_tpu_torch.node.registry import model_dir

    path = model_dir(XL_CKPT_MODEL)
    write_clip_vocab(path / "tokenizer")
    return [load_tokenizer(path, cfg.vocab_size, cfg.eos_token_id,
                           cfg.max_position_embeddings)
            for cfg in FAMILIES["sdxl"].text_encoders]


def xl_serve_phase(torch, registry, slot) -> tuple:
    """SDXL at its published widths, random weights from seed 0 (drawn on
    the card once; every later SDXL phase reuses them), both text towers on
    the synthetic CLIP vocab: the three serve jobs at 1024x1024 on the solo
    path. Error-free envelopes with 1024x1024 PNGs, B1 exactly 1,400 times a
    job and no other kernel. Returns the launches, the blobs and the
    images/s after the first job."""
    from chiaswarm_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = registry.pipeline(XL_MODEL)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe.c.tokenizers = xl_tokenizers()
    seconds, blobs = run_jobs(torch, "xl_serve", slot, registry, jobs=XL_JOBS)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    want = len(XL_JOBS) * SERVE_STEPS * B1_LAUNCHES_PER_XL_EVAL
    ips_after_first = (len(XL_JOBS) - 1) / sum(seconds[1:])
    emit("xl_serve", jobs=len(XL_JOBS), steps=SERVE_STEPS, size=XL_SIZE,
         init_s=init_s, param_bytes=pipe.c.param_bytes(),
         dtype=str(pipe.c.dtype), job_seconds=seconds,
         images_per_s=len(XL_JOBS) / sum(seconds),
         images_per_s_after_first=ips_after_first,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_flash_launches=want)
    if launches["flash_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"xl_serve launched {launches}, expected {want} "
                             "of flash_attention and no other")
    return launched(), blobs, ips_after_first


def xl_lane_serve_phase(torch, registry, slot, solo_blobs: dict) -> tuple:
    """The SDXL serve jobs one after another through the lanes (each alone
    in a lane of 2 rows, UNet batch 4): B1 = 70 x lane steps, the uint8
    difference from xl_serve's image of each seed printed. Then a job at
    guidance 1.0: no lane takes it (no CFG), the solo path serves it at
    UNet batch 1 (1,400 more B1 launches). Returns the launches and the
    blobs."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    get_stepper(slot).shutdown()
    before = stepper_stats(slot)
    seconds, blobs = run_jobs(torch, "xl_lane_serve", slot, registry,
                              lanes=True, jobs=XL_JOBS)
    steps = delta(stepper_stats(slot), before, "steps_executed")
    t0 = time.perf_counter()
    nocfg = synchronous_do_work(dict(XL_NOCFG_JOB), slot, registry)
    nocfg_s = time.perf_counter() - t0
    check_envelope("xl_lane_serve", XL_NOCFG_JOB, nocfg, lanes=False)
    get_stepper(slot).shutdown()
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    want = (steps + SERVE_STEPS) * B1_LAUNCHES_PER_XL_EVAL
    emit("xl_lane_serve", jobs=len(XL_JOBS), steps=SERVE_STEPS,
         job_seconds=seconds, images_per_s=len(XL_JOBS) / sum(seconds),
         steps_executed=steps, nocfg_seconds=nocfg_s,
         nocfg_generation_s=nocfg["pipeline_config"]["generation_s"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_flash_launches=want,
         vs_xl_serve=image_diffs(blobs, solo_blobs))
    if launches["flash_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"xl_lane_serve launched {launches}, expected "
                             f"{want} of flash_attention and no other")
    return launched(), blobs


def xl_lane_burst_phase(torch, registry, slot, solo_ips: float) -> dict:
    """Four SDXL jobs (seeds 11-14) at once through
    ``synchronous_do_work_batch`` at a lane width pinned to 4 (UNet batch
    8): every job on one lane, B1 = 70 x lane steps and no other kernel,
    fewer lane steps than half the jobs' summed steps. Prints lane steps,
    images/s beside xl_serve's after its first job, occupancy and peak
    memory. Returns the launches."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    get_stepper(slot).shutdown()
    with env(CHIASWARM_STEPPER_LANE_WIDTH=str(XL_LANE_WIDTH)):
        before = stepper_stats(slot)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = synchronous_do_work_batch([dict(j) for j in XL_BURST_JOBS],
                                            slot, registry)
        wall_s = time.perf_counter() - t0
        after = stepper_stats(slot)
        get_stepper(slot).shutdown()
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    infos = {}
    for job, result in zip(XL_BURST_JOBS, results):
        check_envelope("xl_lane_burst", job, result, lanes=True)
        infos[job["seed"]] = result["pipeline_config"]["stepper"]
    steps = delta(after, before, "steps_executed")
    summed = sum(j["num_inference_steps"] for j in XL_BURST_JOBS)
    want = steps * B1_LAUNCHES_PER_XL_EVAL
    row_active = delta(after, before, "row_steps_active")
    row_padded = delta(after, before, "row_steps_padded")
    lanes_used = {info["lane"] for info in infos.values()}
    ips = len(XL_BURST_JOBS) / wall_s
    emit("xl_lane_burst", jobs=len(XL_BURST_JOBS), lane_width=XL_LANE_WIDTH,
         wall_s=wall_s, images_per_s=ips, xl_serve_images_per_s=solo_ips,
         vs_xl_serve=ips / solo_ips, steps_executed=steps,
         summed_job_steps=summed, launches=launches,
         expected_flash_launches=want,
         row_steps_active=row_active, row_steps_padded=row_padded,
         occupancy=row_active / max(1, row_active + row_padded),
         step_seconds_ewma=after.get("step_seconds_ewma"),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         lanes=sorted(lanes_used),
         stepper={seed: infos[seed] for seed in sorted(infos)})
    if (launches["flash_attention"] != want or sum(launches.values()) != want
            or len(lanes_used) != 1 or not steps < summed / 2):
        raise AssertionError(
            f"xl_lane_burst failed: launches {launches} (want {want} of "
            f"flash_attention), lanes {lanes_used}, steps {steps} (bar < "
            f"{summed / 2})")
    return launched()


def xl_worker_checkpoint_phase(torch, registry, pool,
                               lane_blobs: dict) -> dict:
    """SDXL from disk through the worker: the drawn weights written under
    ``<settings root>/models/stabilityai__stable-diffusion-xl-base-1.0/``
    in the diffusers layout (``unet/``, ``vae/``, ``text_encoder/``,
    ``text_encoder_2/``, ``tokenizer/``), each tensor at the dtype it
    serves at. A registry with no random fallback loads it (load seconds
    split into file read, device copy and the rest; the load's peak against
    ``param_bytes``; every tensor ``torch.equal`` to its source), then the
    worker serves serve's seed-1 job for that model name against a hive in
    this script: an error-free 1024x1024 PNG bit for bit xl_lane_serve's
    seed 1 (a lone job in a lane of 2 both times), B1 = 70 x lane steps.
    The directory is removed at the end. Returns the launches."""
    import gc
    import shutil

    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    slot = pool.slots[0]
    src = registry.pipeline(XL_MODEL).c
    source = module_states(src)
    path = model_dir(XL_CKPT_MODEL)
    t0 = time.perf_counter()
    written = write_checkpoint(torch, src, path, float32=False)
    write_s = time.perf_counter() - t0
    disk = shutil.disk_usage(path)
    paths = [str(path / name) for name in written["files"]]
    try:
        ck_registry = ModelRegistry(catalog=[{"name": XL_CKPT_MODEL,
                                              "family": "sdxl"}],
                                    device="cuda")
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cached = page_cache_share(paths)
        t0 = time.perf_counter()
        pipe = ck_registry.pipeline(XL_CKPT_MODEL)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        loaded = module_states(pipe.c)
        unequal = [f"{m}.{k}" for m, params in source.items()
                   for k, p in params.items()
                   if loaded[m][k].dtype != p.dtype
                   or not torch.equal(loaded[m][k], p)]
        stats, footprint = pipe.c.load_stats, pipe.c.param_bytes()
        tokenizers = [type(t).__name__ for t in pipe.c.tokenizers]
        del pipe, loaded

        job = dict(XL_JOBS[0], id="worker-ckpt-sdxl-1",
                   model_name=XL_CKPT_MODEL)
        get_stepper(slot).shutdown()
        kernels.reset_launches()
        steps_before = stepper_stats(slot)
        with LocalHive() as hive:
            worker = serve_through_worker(hive, pool, ck_registry, [job])
        steps = delta(stepper_stats(slot), steps_before, "steps_executed")
        get_stepper(slot).shutdown()
        run = launched()
        [result] = [r for r in hive.results if r["id"] == job["id"]]
        blob = check_envelope("xl_worker_checkpoint", job, result, lanes=True)
        out = {
            "model": XL_CKPT_MODEL, "files": written, "write_s": write_s,
            "disk_free_bytes": disk.free, "page_cache_share_at_load": cached,
            "load_s": load_s, "load_stats": stats,
            "load_other_s": load_s - stats["read_s"] - stats["copy_s"],
            "load_peak_bytes": peak, "param_bytes": footprint,
            "peak_over_param_bytes": peak / footprint,
            "tensors_checked": sum(len(v) for v in source.values()),
            "tensors_unequal": unequal[:8], "tokenizers": tokenizers,
            "seconds": trace_rows(worker)[job["id"]],
            "generation_s": result["pipeline_config"]["generation_s"],
            "steps_executed": steps,
            "b1_launches": run["flash_attention"]["launches"],
            "vs_xl_lane_serve": image_diffs({1: blob}, {1: lane_blobs[1]})[1]}
        del ck_registry
    finally:
        shutil.rmtree(path, ignore_errors=True)
    emit("xl_worker_checkpoint", **out)
    b1 = out["b1_launches"]
    if (unequal or tokenizers != ["ClipBpeTokenizer"] * 2
            or b1 != steps * B1_LAUNCHES_PER_XL_EVAL
            or sum(r["launches"] for r in run.values()) != b1
            or not out["vs_xl_lane_serve"]["bit_equal"]):
        raise AssertionError(f"xl_worker_checkpoint: {out}")
    return run


XL_IMG_JOB = dict(XL_JOBS[0], id="img2img-sdxl-51", seed=51,
                  prompt="the same scene as a watercolor", strength=0.75,
                  start_image_uri="/assets/init-51-1024.png")


def xl_img2img_serve_phase(torch, registry, slot, hive: LocalHive) -> dict:
    """One SDXL img2img job at 1024 px (strength 0.75: 15 UNet evals), its
    init image fetched from this script's hive, solo then in a lane
    (``image_solo_and_lanes``: B1 = 70 x evals). Returns both runs."""
    [job] = on_hive(hive, [XL_IMG_JOB])
    out = image_solo_and_lanes(torch, "xl_img2img_serve", registry, slot,
                               [job], B1_LAUNCHES_PER_XL_EVAL, XL_MODEL)
    emit("xl_img2img_serve", solo_job_seconds=out["solo"]["seconds"],
         lane_job_seconds=out["lanes"]["seconds"],
         lanes_vs_solo=image_diffs(out["lanes"]["blobs"],
                                   out["solo"]["blobs"]))
    return {"xl_img2img_serve": out["solo"]["run"],
            "xl_img2img_lane_serve": out["lanes"]["run"]}


def encode_check_phase(torch, registry) -> None:
    """SD1.5's full-width VAE encoder (bf16 weights) at 512 px: its latent
    mean in bf16 against the same weights in float32 (TF32 off), relative
    L2 within 3e-2 (the repo's bf16 bar), no kernel launched. Then, at
    512 px (SD1.5's VAE) and at 1024 px (SDXL's), the median CUDA-event ms
    of the encode alone (``vae.encode(x, noise)`` on an image and posterior
    noise already on the card: device time), of the whole
    ``encode_init_image`` call (the host's float conversion, posterior
    draw and upload inside the events), and the call's peak device memory
    above what was allocated before it."""
    import copy

    import numpy as np

    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.diffusion import _to_float_image

    pipe = registry.pipeline("sd15")
    img = _to_float_image(smooth_image(31, IMG_SIZE))
    x = torch.from_numpy(img).permute(2, 0, 1)[None].to(pipe.c.device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        vae32 = copy.deepcopy(pipe.c.vae).float()
        kernels.reset_launches()
        with torch.inference_mode():
            mean, _ = pipe.c.vae.encode_moments(x)
            ref, _ = vae32.encode_moments(x)
        del vae32
        torch.cuda.synchronize()
        launches = kernel_launches()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rel = float((mean.float() - ref).norm() / ref.norm())
    times = {}
    for name, size in (("sd15", IMG_SIZE), (XL_MODEL, XL_SIZE)):
        p = registry.pipeline(name)
        image = smooth_image(31, size)
        xs = torch.from_numpy(_to_float_image(image)).permute(2, 0, 1)[None]
        xs = xs.contiguous().to(p.c.device)
        lat = size // p.c.family.vae.downscale
        noise = torch.randn((1, p.c.family.vae.latent_channels, lat, lat),
                            generator=torch.Generator().manual_seed(31)
                            ).to(p.c.device)

        def encode(p=p, xs=xs, noise=noise):
            with torch.inference_mode():
                p.c.vae.encode(xs, noise)

        times[f"{name}_{size}px_ms"] = time_ms(torch, encode, warmup=2,
                                               iters=5)
        times[f"{name}_{size}px_call_ms"] = time_ms(
            torch, lambda p=p, image=image, size=size:
            p.encode_init_image(image, size, size, 31), warmup=2, iters=5)
        # the encode's own peak over the memory held before it
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p.encode_init_image(image, size, size, 31)
        torch.cuda.synchronize()
        times[f"{name}_{size}px_peak_bytes"] = (
            torch.cuda.max_memory_allocated() - held)
    emit("encode_check", vae_dtype=str(pipe.c.dtype),
         latent_shape=list(mean.shape),
         rel_l2_vs_fp32=rel, max_abs_vs_fp32=float(
             (mean.float() - ref).abs().max()),
         launches=launches, **times, note="*_px_ms: device ms of the "
         "encode alone, inputs on the card; *_px_call_ms: event ms of the "
         "whole encode_init_image, host conversion, draw and upload inside")
    if not rel <= 3e-2 or any(launches.values()) or not np.isfinite(rel):
        raise AssertionError(f"encode_check: relative L2 {rel} (bar 3e-2), "
                             f"launches {launches}")


# ---- the gray-failure guard ----------------------------------------------

GUARD_WEDGE_STEP = 12        # after the step-8 checkpoint, before step 16
GUARD_RESUME_STEP = 8        # CHIASWARM_STEPPER_CKPT_EVERY's default
GUARD_KNOBS = {"CHIASWARM_GUARD_HANG_FLOOR_S": "1",
               "CHIASWARM_GUARD_HANG_CEIL_S": "20"}
GUARD_JOBS = [dict(JOBS[0], id="guard-txt2img-1"),
              dict(INPAINT_JOBS[0], id="guard-inpaint-41")]
GUARD_NAN_JOBS = [dict(JOBS[0], id="guard-nan-1"),
                  dict(JOBS[1], id="guard-nan-2")]
GUARD_XL_JOBS = [dict(XL_JOBS[0], id="guard-sdxl-1"),
                 dict(XL_JOBS[1], id="guard-sdxl-2")]


def fresh_guard(slot):
    """A device guard of its own on ``slot`` (a worker sets its own)."""
    from chiaswarm_tpu_torch.obs.metrics import Registry
    from chiaswarm_tpu_torch.serving.guard import DeviceGuard, _slot_devices

    slot._guard = DeviceGuard(metrics_registry=Registry())
    slot._guard.seed_devices(_slot_devices(slot))
    return slot._guard


@contextlib.contextmanager
def watch_lanes(pipe):
    """Counts ``pipe``'s lane step dispatches (``stepper_step`` calls,
    condemned ones included) and records when each lane was condemned and
    when the first dispatch after the first condemnation began."""
    from chiaswarm_tpu_torch.serving.stepper import Lane

    rec = {"dispatches": 0, "condemned_t": [], "first_after_t": None}
    step, condemn = pipe.stepper_step, Lane.condemn

    def counted(*args, **kw):
        if rec["condemned_t"] and rec["first_after_t"] is None:
            rec["first_after_t"] = time.monotonic()
        rec["dispatches"] += 1
        return step(*args, **kw)

    def timed_condemn(lane, reason):
        if not lane._condemned:
            rec["condemned_t"].append(time.monotonic())
        condemn(lane, reason)

    pipe.stepper_step, Lane.condemn = counted, timed_condemn
    try:
        yield rec
    finally:
        del pipe.stepper_step
        Lane.condemn = condemn


def guard_stats(after: dict, before: dict) -> dict:
    return {key: delta(after, before, key) for key in (
        "steps_executed", "lanes_condemned", "rows_hung", "rows_resumed",
        "rows_invalid", "resumes_rejected", "rows_completed")}


def wedged_pair(torch, phase: str, registry, slot, jobs: list[dict],
                model: str, per_eval: int) -> dict:
    """``jobs`` (two) through ``synchronous_do_work_batch`` in a lane pinned
    at 2 rows, both admitted at its first step, twice: uninterrupted, then
    with lane step ``GUARD_WEDGE_STEP`` wedged (``CHIASWARM_CHAOS_WEDGE_STEP``)
    past its hang budget (floor 1 s). The watchdog condemns the lane, both
    jobs resume at step ``GUARD_RESUME_STEP`` in one fresh lane, also
    admitted together, and each image is its uninterrupted run bit for bit.
    B1 = ``per_eval`` x lane step dispatches, the condemned lane's
    included."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving import guard
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    pipe = registry.pipeline(model)
    hold = {job["id"]: 0 for job in jobs}
    get_stepper(slot).shutdown()
    device_guard = fresh_guard(slot)
    with env(CHIASWARM_STEPPER_LANE_WIDTH="2", **GUARD_KNOBS):
        with lane_admissions(hold=hold):
            ref = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                            registry)
        get_stepper(slot).shutdown()
        ref_blobs = [check_envelope(phase, j, r, lanes=True)
                     for j, r in zip(jobs, ref)]
        wedge_s = 6.0
        budget = get_stepper(slot).hang_budget()
        guard.reset_chaos()
        before = stepper_stats(slot)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with env(CHIASWARM_CHAOS_WEDGE_STEP=f"{GUARD_WEDGE_STEP}:{wedge_s}"), \
                lane_admissions(hold=hold), watch_lanes(pipe) as rec, \
                watch_pipe(torch, pipe) as pipe_rec:
            healed = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                               registry)
        healed_s = time.perf_counter() - t0
        launches, run = kernel_launches(), launched()
        get_stepper(slot).shutdown(timeout_s=60)  # joins the wedged thread
    stats = guard_stats(stepper_stats(slot), before)
    blobs, infos = [], []
    for job, result in zip(jobs, healed):
        blobs.append(check_envelope(phase, job, result, lanes=True))
        infos.append(result["pipeline_config"]["stepper"])
    diffs = image_diffs(dict(enumerate(blobs)), dict(enumerate(ref_blobs)))
    out = {
        "jobs": [j["id"] for j in jobs], "wedge_step": GUARD_WEDGE_STEP,
        "wedge_s": wedge_s, "hang_budget_s": budget,
        "resume_step": [info["resume_step"] for info in infos],
        "resumed_lanes": sorted({info["lane"] for info in infos}),
        "counters": stats,
        "guard": {k: device_guard.snapshot()[k] for k in
                  ("hangs", "condemned_lanes", "health")},
        "condemned_to_first_resumed_step_s": (
            rec["first_after_t"] - rec["condemned_t"][0]
            if rec["condemned_t"] and rec["first_after_t"] else None),
        "lane_step_dispatches": rec["dispatches"], "seconds": healed_s,
        "launches": launches,
        "expected_flash_launches": per_eval * rec["dispatches"],
        "vs_uninterrupted": diffs}
    failed = []
    if stats["lanes_condemned"] != 1 or stats["rows_resumed"] != len(jobs):
        failed.append(f"counters {stats}")
    if out["resume_step"] != [GUARD_RESUME_STEP] * len(jobs) or \
            len(out["resumed_lanes"]) != 1:
        failed.append(f"resume {out['resume_step']} in lanes "
                      f"{out['resumed_lanes']}")
    if not all(d["bit_equal"] for d in diffs.values()):
        failed.append(f"images {diffs}")
    if launches["flash_attention"] != out["expected_flash_launches"] or \
            sum(launches.values()) != launches["flash_attention"]:
        failed.append(f"launches {launches}")
    return {"out": out, "failed": failed, "run": run, "pipe_rec": pipe_rec}


def guard_lane_phase(torch, registry, slot, hive: LocalHive) -> dict:
    """A lane of 2: serve's seed-1 txt2img job and an inpaint job (fetched
    from this script's hive), wedged at lane step 12 (``wedged_pair``): both
    resume at step 8 bit for bit, and the inpaint job's final latents equal
    its encoded ``known`` latents exactly where the mask keeps them."""
    from chiaswarm_tpu_torch.pipelines.diffusion import latent_mask

    jobs = on_hive(hive, GUARD_JOBS)
    res = wedged_pair(torch, "guard_lane", registry, slot, jobs, "sd15",
                      B1_LAUNCHES_PER_UNET_EVAL)
    rec = res["pipe_rec"]
    pipe = registry.pipeline("sd15")
    f = pipe.c.family.vae.downscale
    kept = torch.from_numpy(latent_mask(rect_mask(IMG_SIZE) / 255.0,
                                        IMG_SIZE // f, IMG_SIZE // f, f) == 0
                            ).to(pipe.c.device)
    # the lane decodes its retiring jobs in slot order: txt2img, inpaint
    known, final = rec["encodes"][-1][0], rec["final"][-1][:1]
    exact = bool(torch.equal(final[:, :, kept], known[:, :, kept]))
    res["out"]["inpaint_kept_latents_exact"] = exact
    emit("guard_lane", **res["out"])
    if not exact:
        res["failed"].append("the inpaint job's kept latents moved")
    if res["failed"]:
        raise AssertionError("guard_lane: " + "; ".join(res["failed"]))
    return res["run"]


def guard_xl_phase(torch, registry, slot) -> dict:
    """``guard_lane`` for SDXL at 1024 px, two txt2img jobs: the rows'
    pooled text is encoded again at re-admission, and both resume at step
    8 bit for bit; B1 = 70 x lane step dispatches."""
    res = wedged_pair(torch, "guard_xl", registry, slot, GUARD_XL_JOBS,
                      XL_MODEL, B1_LAUNCHES_PER_XL_EVAL)
    emit("guard_xl", **res["out"])
    if res["failed"]:
        raise AssertionError("guard_xl: " + "; ".join(res["failed"]))
    return res["run"]


def guard_nan_phase(torch, registry, pool) -> dict:
    """Seeds 1 and 2 in a lane of 2 through the worker, row 1 poisoned with
    NaN after lane step 5 (``CHIASWARM_CHAOS_NAN_STEP="5:1"``): the step-8
    checkpoint's finite check retires seed 2's job alone, which uploads a
    non-fatal ``invalid_output`` envelope, and the worker's
    ``chiaswarm_guard_invalid_outputs_total`` reads 1; seed 1's image is
    bit for bit its unpoisoned twin (the same two jobs in the same slots,
    through the executor)."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.node.resilience import classify_result
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving import guard
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    slot = pool.slots[0]
    jobs = GUARD_NAN_JOBS
    hold = {job["id"]: 0 for job in jobs}
    get_stepper(slot).shutdown()
    with env(CHIASWARM_STEPPER_LANE_WIDTH="2"):
        with lane_admissions(hold=hold):
            twin = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                             registry)
        get_stepper(slot).shutdown()
        twin_blob = check_envelope("guard_nan", jobs[0], twin[0], lanes=True)
        guard.reset_chaos()
        before = stepper_stats(slot)
        kernels.reset_launches()
        with env(CHIASWARM_CHAOS_NAN_STEP="5:1"), \
                lane_admissions(hold=hold), LocalHive() as hive:
            worker = serve_through_worker(hive, pool, registry,
                                          [dict(j) for j in jobs])
            results = {r["id"]: r for r in hive.results}
        launches, run = kernel_launches(), launched()
        get_stepper(slot).shutdown()
    stats = guard_stats(stepper_stats(slot), before)
    ok_blob = check_envelope("guard_nan", jobs[0], results[jobs[0]["id"]],
                             lanes=True)
    bad = results[jobs[1]["id"]]
    invalid = worker.metrics.get(
        "chiaswarm_guard_invalid_outputs_total").value(model="sd15")
    out = {"counters": stats, "launches": launches,
           "expected_flash_launches":
               stats["steps_executed"] * B1_LAUNCHES_PER_UNET_EVAL,
           "poisoned_envelope": {
               "error_kind": bad["pipeline_config"].get("error_kind"),
               "fatal_error": bool(bad.get("fatal_error")),
               "classified": classify_result(bad)},
           "guard_invalid_outputs_total": invalid,
           "guard": worker.guard.snapshot()["health"],
           "row0_vs_twin": image_diffs({1: ok_blob}, {1: twin_blob})[1],
           "uploads": len(hive.results)}
    emit("guard_nan", **out)
    if (out["poisoned_envelope"] != {"error_kind": "invalid_output",
                                     "fatal_error": False,
                                     "classified": "invalid_output"}
            or invalid != 1 or stats["rows_invalid"] != 1
            or not out["row0_vs_twin"]["bit_equal"] or out["uploads"] != 2):
        raise AssertionError(f"guard_nan: {out}")
    check_b1("guard_nan", launches, out["expected_flash_launches"])
    return run


def guard_solo_phase(torch, registry, pool, solo_blob: str) -> dict:
    """The solo path (``CHIASWARM_STEPPER=0``) under the watchdog, through
    the worker: serve's seed-1 job once (its key warm), then again with the
    diffusion callback wrapped, once, in a sleep 3 s past its budget
    (factor 2: steps x the lane step EWMA x 2, floor 1 s). ``StepHung`` is raised and
    classified ``transient``, the retry ladder re-runs the job, and its
    image is bit for bit the serve phase's solo image."""
    import functools

    from chiaswarm_tpu_torch.node import executor
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.guard import solo_hang_budget_s
    from chiaswarm_tpu_torch.serving.stepper import get_stepper
    from chiaswarm_tpu_torch.workloads import diffusion as workload

    slot = pool.slots[0]
    real_cb, real_execute = workload.diffusion_callback, executor._execute
    attempts: list = []
    slept: list = []

    @functools.wraps(real_cb)
    def sleepy(*args, **kw):
        if not slept:  # once: the retry runs the plain callback
            slept.append(budget + 3.0)
            time.sleep(budget + 3.0)
        return real_cb(*args, **kw)

    def recorded(*args, **kw):
        result = real_execute(*args, **kw)
        cfg = result["pipeline_config"]
        attempts.append({"error_class": cfg.get("error_class"),
                         "error_kind": cfg.get("error_kind")})
        return result

    knobs = dict(GUARD_KNOBS, CHIASWARM_GUARD_HANG_FACTOR="2",
                 CHIASWARM_STEPPER="0")
    ewma = get_stepper(slot).step_ewma()
    with env(**knobs):
        budget = solo_hang_budget_s(ewma, SERVE_STEPS)
        warm = executor.synchronous_do_work(dict(JOBS[0], id="guard-solo-0"),
                                            slot, registry)
        check_envelope("guard_solo", JOBS[0], warm, lanes=False)
        kernels.reset_launches()
        workload.diffusion_callback, executor._execute = sleepy, recorded
        try:
            with LocalHive() as hive:
                job = dict(JOBS[0], id="guard-solo-1")
                worker = serve_through_worker(hive, pool, registry, [job])
                [result] = hive.results
        finally:
            workload.diffusion_callback = real_cb
            executor._execute = real_execute
        launches, run = kernel_launches(), launched()
    blob = check_envelope("guard_solo", job, result, lanes=False)
    snap = worker.guard.snapshot()
    out = {"hang_budget_s": budget, "step_ewma_s": ewma, "slept_s": slept,
           "attempts": attempts, "jobs_retried": worker.stats.jobs_retried,
           "guard": {k: snap[k] for k in ("hangs", "health")},
           "solo_hangs": worker.metrics.get(
               "chiaswarm_guard_hangs_total").value(phase="solo"),
           "vs_serve": image_diffs({1: blob}, {1: solo_blob})[1],
           "launches": launches,
           "expected_flash_launches":
               2 * SERVE_STEPS * B1_LAUNCHES_PER_UNET_EVAL}
    emit("guard_solo", **out)
    if (attempts != [{"error_class": "StepHung", "error_kind": "transient"},
                     {"error_class": None, "error_kind": None}]
            or out["jobs_retried"] != 1 or out["solo_hangs"] != 1
            or not out["vs_serve"]["bit_equal"]):
        raise AssertionError(f"guard_solo: {out}")
    check_b1("guard_solo", launches, out["expected_flash_launches"])
    return run


def guard_worker_phase(torch, registry, pool) -> dict:
    """The healing ladder through the worker (``guard_cache_flush_after=1``,
    ``guard_quarantine_after=2``, ``guard_restart_after=3``, polls every
    0.1 s, hang ceiling 3 s): seeds 1 and 2 in a lane of 2, whose first
    dispatch wedges for 8 s (a lane's first dispatch at a width runs under
    the ceiling). The seam is re-armed once, at the condemnation, so the
    fresh lane the jobs re-enter wedges at its first dispatch too: two
    hangs with no healthy step between them (a healthy step would shrink
    the sickness streak). The first queues cache_flush and quarantine, the
    second restart, and the jobs finish on the per-job path. The worker
    applies the rungs in that order, declines to quarantine its one card
    (the slot's mesh unchanged), drains gracefully and ``run()`` returns by
    itself with exit code 73; each job is settled at the hive exactly once,
    without error."""
    import asyncio

    from chiaswarm_tpu_torch.node.settings import Settings
    from chiaswarm_tpu_torch.node.worker import Worker
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving import guard
    from chiaswarm_tpu_torch.serving.stepper import Lane, get_stepper

    slot = pool.slots[0]
    jobs = [dict(JOBS[0], id="guard-worker-1"),
            dict(JOBS[1], id="guard-worker-2")]
    get_stepper(slot).shutdown()
    mesh, epoch = slot.mesh, guard.flush_epoch()
    condemn, rearmed, applied = Lane.condemn, [], []

    def condemn_and_rearm(lane, reason):
        condemn(lane, reason)
        if not rearmed:
            rearmed.append(lane.lane_id)
            guard.reset_chaos()

    guard.reset_chaos()
    kernels.reset_launches()
    before = stepper_stats(slot)
    t0 = time.perf_counter()
    with env(CHIASWARM_STEPPER_LANE_WIDTH="2",
             CHIASWARM_CHAOS_WEDGE_STEP="1:8",
             **dict(GUARD_KNOBS, CHIASWARM_GUARD_HANG_CEIL_S="3")), \
            LocalHive() as hive:
        hive.submit(*jobs)
        worker = Worker(Settings(hive_uri=hive.uri, hive_token="chip-smoke",
                                 worker_name="chip-smoke-guard",
                                 poll_busy_s=0.1, poll_idle_s=0.1,
                                 guard_cache_flush_after=1,
                                 guard_quarantine_after=2,
                                 guard_restart_after=3),
                        pool=pool, registry=registry)
        take = worker.guard.take_actions

        def recorded_take():
            actions = take()
            applied.extend(a.rung for a in actions)
            return actions

        worker.guard.take_actions = recorded_take
        Lane.condemn = condemn_and_rearm
        try:
            asyncio.run(asyncio.wait_for(worker.run(), timeout=600))
        finally:
            Lane.condemn = condemn
        results = list(hive.results)
        get_stepper(slot).shutdown(timeout_s=60)
    run_s = time.perf_counter() - t0
    launches, run = kernel_launches(), launched()
    stats = guard_stats(stepper_stats(slot), before)
    ids = [r["id"] for r in results]
    out = {"exit_code": worker.exit_code, "rungs_applied": applied,
           "quarantined": worker.guard.snapshot()["quarantined"],
           "mesh_unchanged": slot.mesh is mesh,
           "flush_epochs": guard.flush_epoch() - epoch,
           "guard": worker.guard.snapshot(), "counters": stats,
           "settled": ids, "errors": [r["pipeline_config"].get("error")
                                      for r in results],
           "on_lanes": ["stepper" in r["pipeline_config"] for r in results],
           "run_s": run_s, "launches": launches}
    emit("guard_worker", **out)
    if (worker.exit_code != guard.GUARD_RESTART_EXIT_CODE
            or applied != ["cache_flush", "device_quarantine", "restart"]
            or not out["mesh_unchanged"] or out["flush_epochs"] != 1
            or sorted(ids) != sorted(j["id"] for j in jobs)
            or any(out["errors"]) or stats["lanes_condemned"] != 2):
        raise AssertionError(f"guard_worker: {out}")
    for job, result in zip(jobs, results):
        check_envelope("guard_worker", job, result, lanes=False)
    return run


def guard_child(hive: LocalHive, root: Path) -> dict:
    """``python -m chiaswarm_tpu_torch.node.worker`` as a child process on
    ``CKPT_MODEL`` (its directory linked into the child's settings root),
    with ``guard_cache_flush_after=1``, ``guard_quarantine_after=2`` and
    ``guard_restart_after=2`` in its ``settings.json`` and lane step 3
    wedged by ``CHIASWARM_CHAOS_WEDGE_STEP``: the one hang queues all three
    rungs, the child declines to quarantine its card, drains, uploads the
    job once without error and exits with 73."""
    from chiaswarm_tpu_torch.node.registry import model_dir

    child_root = root / "guard-child"
    (child_root / "models").mkdir(parents=True, exist_ok=True)
    src = model_dir(CKPT_MODEL)
    (child_root / "models" / src.name).symlink_to(src)
    (child_root / "models.json").write_text(json.dumps(
        [{"name": CKPT_MODEL, "family": "sd15"}]))
    (child_root / "settings.json").write_text(json.dumps({
        "worker_name": "chip-smoke-guard-child", "poll_busy_s": 0.1,
        "poll_idle_s": 0.1,
        "guard_cache_flush_after": 1, "guard_quarantine_after": 2,
        "guard_restart_after": 2}))
    job = dict(JOBS[0], id="guard-child-1", model_name=CKPT_MODEL)
    hive.submit(job)
    child_env = dict(os.environ, SDAAS_URI=hive.uri, SDAAS_TOKEN="chip-smoke",
                     SWARM_TPU_ROOT=str(child_root),
                     CHIASWARM_CHAOS_WEDGE_STEP="3:6", **GUARD_KNOBS)
    log_path = child_root / "child.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        child = subprocess.Popen(
            [sys.executable, "-m", "chiaswarm_tpu_torch.node.worker"],
            cwd=ROOT, env=child_env, stdout=log_file,
            stderr=subprocess.STDOUT)
        try:
            rc = child.wait(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    text = log_path.read_text()
    results = [r for r in hive.results if r["id"] == job["id"]]
    out = {"rc": rc, "exit_s": time.perf_counter() - t0,
           "settled": len(results),
           "error": results[0]["pipeline_config"].get("error")
           if results else None,
           "condemned": "CONDEMNED" in text,
           "declined": "cannot quarantine device" in text,
           "restart": "self-restart requested" in text,
           "log_tail": text.splitlines()[-4:]}
    if (rc != 73 or len(results) != 1 or out["error"] is not None
            or not (out["condemned"] and out["declined"] and out["restart"])):
        raise AssertionError(f"the guard child failed: {out}")
    return out


def guard_cost_phase(torch, registry, slot) -> dict:
    """lane_burst's nine jobs as one burst at its pinned width of 8, four
    times: with the guard off (``CHIASWARM_GUARD=0``: no watchdog, no
    checkpoints), on (checkpoints every 8 steps), on, off. Prints each
    run's images/s, the mean ms of one checkpoint boundary (the copy of the
    lane's latents and history to the host, the finite check, the generator
    states) and the card. A measurement: every image is held bit for bit
    across the runs, the times are not gated."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.obs.metrics import REGISTRY
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    jobs = BURST_JOBS + [LATE_JOB]
    # every run the same composition: eight rows at step 0, the ninth in
    # the first row to free
    hold = {job["id"]: 0 for job in jobs}
    hist = REGISTRY.get("chiaswarm_stepper_checkpoint_seconds")
    runs, blobs = [], {}
    kernels.reset_launches()
    for guard_on in (False, True, True, False):
        get_stepper(slot).shutdown()
        before = stepper_stats(slot)
        n0, s0 = hist.count(), hist.sum()
        with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH),
                 CHIASWARM_GUARD="1" if guard_on else "0"), \
                lane_admissions(hold=hold):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                                registry)
            wall_s = time.perf_counter() - t0
        n, s = hist.count() - n0, hist.sum() - s0
        runs.append({"guard": guard_on, "wall_s": wall_s,
                     "images_per_s": len(jobs) / wall_s,
                     "steps_executed": delta(stepper_stats(slot), before,
                                             "steps_executed"),
                     "checkpoints": n,
                     "checkpoint_ms_mean": 1e3 * s / n if n else None})
        for job, result in zip(jobs, results):
            blob = check_envelope("guard_cost", job, result, lanes=True)
            if blobs.setdefault(job["id"], blob) != blob:
                raise AssertionError(f"guard_cost: job {job['id']}'s image "
                                     "changed between runs")
    get_stepper(slot).shutdown()
    run = launched()
    on = [r for r in runs if r["guard"]]
    off = [r for r in runs if not r["guard"]]
    emit("guard_cost", card=nvidia_smi_line(), runs=runs,
         images_per_s_guard_off=statistics.mean(r["images_per_s"]
                                                for r in off),
         images_per_s_guard_on=statistics.mean(r["images_per_s"] for r in on),
         checkpoint_ms_mean=statistics.mean(r["checkpoint_ms_mean"]
                                            for r in on),
         checkpoints_per_run=[r["checkpoints"] for r in runs])
    if any(r["checkpoints"] for r in off) or not all(r["checkpoints"]
                                                     for r in on):
        raise AssertionError(f"guard_cost: checkpoints {runs}")
    return run


# ---- the safety checker and ControlNet ----

CHECKER_CONCEPTS = 17   # the published checker's concept embeddings
CHECKER_SPECIAL = 3     # and its special-care embeddings
CHECKER_BAR = 2e-4      # float32 card against float32 CPU
CHECKER_TIMED = 10
CN_MODEL = "lllyasviel/control_v11p_sd15_canny"  # the hive's default name
XL_CN_MODEL = "diffusers/controlnet-canny-sdxl-1.0"
CN_ZERO_CONV_STD = 0.01  # the seeded stand-in for trained zero convs
# how far a control pair's lane images may stray from their solo images
# beyond the txt2img pair's: uint8 levels of the largest difference, and
# the share of values within one level
CN_LANE_MARGIN = {"max": 3, "within_one": 0.05}
# the SD1.5 ControlNet's down trunk adds 4 self-attentions at >= 1024
# tokens an eval (two transformers at 4096 and two at 1024; its mid block
# is at 64); SDXL's adds 4 at 4096, 20 at 1024 and its 10-deep mid block
B1_LAUNCHES_PER_CONTROL_EVAL = B1_LAUNCHES_PER_UNET_EVAL + 4
B1_LAUNCHES_PER_XL_CONTROL_EVAL = B1_LAUNCHES_PER_XL_EVAL + 4 + 20 + 10


def checker_tower_state(torch, seed: int = 0) -> dict:
    """The safety checker's CLIP vision tower at its published widths
    (ViT-L/14: 1024 hidden, 24 layers, 16 heads, 4096 intermediate, patch
    14 at 224, projection 768), random from ``seed`` on the host with Flax's
    default distributions, in the checker's layout (the trunk under
    ``vision_model.vision_model.``), float32."""
    from chiaswarm_tpu_torch.models.clip import ClipVisionEncoder, VisionConfig
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init

    tower = ClipVisionEncoder(VisionConfig())
    gen = torch.Generator().manual_seed(seed)
    flax_default_init(tower, gen)
    with torch.no_grad():
        tower.vision_model.embeddings.class_embedding.normal_(
            0.0, 0.02, generator=gen)
    return {("vision_model." + k if k.startswith("vision_model.") else k):
            v for k, v in tower.state_dict().items()}


def write_checker(torch, checker_dir: Path, state: dict) -> None:
    """The tower as ``model.safetensors`` and the snapshot's
    ``config.json`` (the concept buffers go in a file of their own,
    ``write_concepts``)."""
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file

    checker_dir.mkdir(parents=True, exist_ok=True)
    save_file(state, checker_dir / "model.safetensors", {"format": "pt"})
    (checker_dir / "config.json").write_text(json.dumps({"vision_config": {
        "hidden_size": 1024, "intermediate_size": 4096,
        "num_hidden_layers": 24, "num_attention_heads": 16,
        "image_size": 224, "patch_size": 14, "projection_dim": 768}}))


def write_concepts(torch, checker_dir: Path, embeds, flag: int) -> dict:
    """The four concept buffers, as ``concepts.safetensors`` beside the
    tower, such that of the images whose (unnormalised) ``embeds`` are given
    image ``flag`` flags and the others do not: 17 concept and 3
    special-care embeddings from seed 1, concept 0 along the flagged
    image's direction away from the others', its threshold half way
    between, every other threshold 0.05 above the images' cosines (no
    special-care hit). Returns the thresholds and the least distance of a
    cosine from its threshold."""
    import numpy as np

    from chiaswarm_tpu_torch.convert.safetensors_io import save_file

    e = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
    others = [i for i in range(len(e)) if i != flag]
    rng = np.random.default_rng(1)
    concept = rng.standard_normal((CHECKER_CONCEPTS, e.shape[1]))
    special = rng.standard_normal((CHECKER_SPECIAL, e.shape[1]))
    away = e[flag] - e[others].mean(axis=0)
    concept[0] = away / np.linalg.norm(away)

    def cos(b):
        return e @ (b / np.linalg.norm(b, axis=-1, keepdims=True)).T

    c, s = cos(concept), cos(special)
    concept_t = c.max(axis=0) + 0.05
    concept_t[0] = (c[flag, 0] + c[others, 0].max()) / 2
    special_t = np.full(CHECKER_SPECIAL, s.max() + 0.05)
    margin = float(min(np.abs(c - concept_t).min(),
                       np.abs(s - special_t).min()))
    if margin < 1e-3:
        raise AssertionError(f"the concept thresholds sit within {margin} "
                             "of a cosine")
    save_file({
        "concept_embeds": torch.from_numpy(concept.astype(np.float32)),
        "concept_embeds_weights": torch.from_numpy(
            concept_t.astype(np.float32)),
        "special_care_embeds": torch.from_numpy(special.astype(np.float32)),
        "special_care_embeds_weights": torch.from_numpy(
            special_t.astype(np.float32))},
        checker_dir / "concepts.safetensors", {"format": "pt"})
    return {"flag_threshold": float(concept_t[0]),
            "flag_cosines": c[:, 0].tolist(), "margin": margin}


def checker_timing(torch, checker, image) -> dict:
    """One image through the checker (preprocess on the host, the tower on
    the card, the cosine head on the host): the median host-clock ms and
    CUDA-event ms of ``CHECKER_TIMED`` whole calls, the preprocessing's
    host ms, and the tower's device ms alone on an input already on the
    card (events around it, behind a device sleep)."""
    import numpy as np

    batch = image[None]
    checker(batch)  # warm
    host, events, prep = [], [], []
    for _ in range(CHECKER_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        checker(batch)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        t1 = time.perf_counter()
        pixels = checker.preprocess(batch)
        prep.append((time.perf_counter() - t1) * 1e3)
    x = torch.from_numpy(np.ascontiguousarray(pixels)).permute(
        0, 3, 1, 2).contiguous().cuda()
    with torch.inference_mode():
        tower_ms = time_ms(torch, lambda: checker.tower(x))
    return {"host_ms": statistics.median(host),
            "event_ms": statistics.median(events),
            "preprocess_host_ms": statistics.median(prep),
            "tower_device_ms": tower_ms}


def safety_check_phase(torch) -> dict:
    """The checker at its published widths, random from a seed, written as
    the standalone checker directory of the run's settings root: loaded on
    the card and on the CPU, both float32. Two 512 px pictures and one at
    1024 px: the card's embeddings against the CPU's within 2e-4 (relative
    to the largest), the concept thresholds then set from the CPU's so the
    first flags and the second does not, and both checkers' flags equal.
    Prints the checker's bytes and its ms per image at 512 and 1024 px.
    Returns the checker directory and the tower's state."""
    import numpy as np

    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.workloads import safety

    t0 = time.perf_counter()
    state = checker_tower_state(torch)
    checker_dir = model_dir(safety.CHECKER_MODEL)
    write_checker(torch, checker_dir, state)
    images = np.stack([smooth_image(61, IMG_SIZE), smooth_image(62, IMG_SIZE)])
    big = smooth_image(63, XL_SIZE)[None]
    write_concepts(torch, checker_dir, np.ones((2, 768)) * [[1], [-1]], 0)
    cpu = safety.SafetyChecker(checker_dir, "cpu")
    want = cpu.embed(cpu.preprocess(images))
    write_s = time.perf_counter() - t0
    concepts = write_concepts(torch, checker_dir, want, 0)
    cpu = safety.SafetyChecker(checker_dir, "cpu")
    t1 = time.perf_counter()
    card = safety.SafetyChecker(checker_dir, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    got = card.embed(card.preprocess(images))
    want_big = cpu.embed(cpu.preprocess(big))
    got_big = card.embed(card.preprocess(big))
    err = max(float(np.abs(got - want).max()),
              float(np.abs(got_big - want_big).max()))
    scale = max(1.0, float(np.abs(want).max()), float(np.abs(want_big).max()))
    flags, cpu_flags = card(images), cpu(images)
    out = {"param_bytes": card.param_bytes(), "write_s": write_s,
           "load_s": load_s, "max_abs_err": err, "bar": CHECKER_BAR * scale,
           "embed_abs_max": scale, "flags": flags, "cpu_flags": cpu_flags,
           "big_flags": card(big), "big_cpu_flags": cpu(big), **concepts,
           "px512": checker_timing(torch, card, images[0]),
           "px1024": checker_timing(torch, card, big[0])}
    emit("safety_check", **out)
    if err > CHECKER_BAR * scale:
        raise AssertionError(f"safety_check: the card's embeddings are "
                             f"{err} off the CPU's")
    if flags != cpu_flags or flags != [True, False] or \
            out["big_flags"] != out["big_cpu_flags"]:
        raise AssertionError(f"safety_check: flags {out}")
    del card, cpu
    return {"dir": checker_dir}


def safety_serve_phase(torch, registry, slot, checker: dict,
                       solo_blobs: dict) -> dict:
    """The checker of safety_check in the standalone checker directory,
    its thresholds set from the CPU embeddings of serve's seed-1 and seed-2
    images so seed 1 flags and seed 2 does not: those two jobs solo (bit
    for bit serve's images), the same pair admitted together into one
    adaptive lane, and SDXL's seed 1 at 1024 px solo. Each envelope's ``nsfw`` and
    ``nsfw_flags`` equal the CPU checker's flags on its decoded image; the
    solo pair flags seed 1 alone. B1 = 10 x evals (70 for SDXL). The
    checker directory is removed at the end, so later phases run without
    one."""
    import shutil

    import numpy as np

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper
    from chiaswarm_tpu_torch.workloads import safety

    checker_dir = checker["dir"]
    cpu = safety.SafetyChecker(checker_dir, "cpu")
    refs = np.stack([decode_png(solo_blobs[s]) for s in (1, 2)]).astype(
        np.uint8)
    concepts = write_concepts(torch, checker_dir,
                              cpu.embed(cpu.preprocess(refs)), 0)
    cpu = safety.SafetyChecker(checker_dir, "cpu")
    safety._CACHE.clear()
    checked: list = []

    def hold(phase, result, job, lanes=False):
        cfg = result["pipeline_config"]
        blob = check_envelope(phase, job, result, lanes)
        flags = cpu(decode_png(blob).astype(np.uint8)[None])
        checked.append({"phase": phase, "id": job["id"],
                        "nsfw": result["nsfw"], "nsfw_flags":
                        cfg.get("nsfw_flags"), "cpu_flags": flags,
                        "generation_s": cfg["generation_s"],
                        "lane_width": cfg.get("stepper", {}).get(
                            "lane_width")})
        if cfg.get("nsfw_flags") != flags or result["nsfw"] != any(flags) \
                or cfg["nsfw"] != any(flags):
            raise AssertionError(f"{phase} {job['id']}: envelope "
                                 f"{cfg.get('nsfw_flags')} against the CPU "
                                 f"checker's {flags}")
        return blob

    kernels.reset_launches()
    try:
        with env(CHIASWARM_STEPPER="0"):
            from chiaswarm_tpu_torch.node.executor import synchronous_do_work

            solo = {}
            for job in JOBS[:2]:
                job = dict(job, id=f"safety-{job['seed']}")
                solo[job["seed"]] = hold("safety_serve_solo",
                                         synchronous_do_work(
                                             dict(job), slot, registry), job)
            solo_launches = kernel_launches()
            check_b1("safety_serve_solo", solo_launches,
                     2 * SERVE_STEPS * B1_LAUNCHES_PER_UNET_EVAL)
        with env(CHIASWARM_STEPPER="1"):
            pair = [dict(job, id=f"safety-lane-{job['seed']}")
                    for job in JOBS[:2]]
            get_stepper(slot).shutdown()
            before = stepper_stats(slot)
            with lane_admissions(hold={job["id"]: 0 for job in pair}):
                results = synchronous_do_work_batch(
                    [dict(j) for j in pair], slot, registry)
            for result, job in zip(results, pair):
                hold("safety_serve_lanes", result, job, lanes=True)
            steps = delta(stepper_stats(slot), before, "steps_executed")
            get_stepper(slot).shutdown()
            lane_launches = {k: v - solo_launches[k]
                             for k, v in kernel_launches().items()}
            check_b1("safety_serve_lanes", lane_launches,
                     steps * B1_LAUNCHES_PER_UNET_EVAL)
        with env(CHIASWARM_STEPPER="0"):
            job = dict(XL_JOBS[0], id="safety-sdxl-1")
            before_xl = kernel_launches()
            hold("safety_serve_xl", synchronous_do_work(dict(job), slot,
                                                        registry), job)
            xl_launches = {k: v - before_xl[k]
                           for k, v in kernel_launches().items()}
            check_b1("safety_serve_xl", xl_launches,
                     SERVE_STEPS * B1_LAUNCHES_PER_XL_EVAL)
        run = launched()
    finally:
        shutil.rmtree(checker_dir, ignore_errors=True)
        safety._CACHE.clear()
    solo_flags = [c["nsfw_flags"] for c in checked[:2]]
    emit("safety_serve", checked=checked, lane_steps=steps, **concepts,
         solo_bit_equal_serve={s: bool((decode_png(solo[s])
                                        == decode_png(solo_blobs[s])).all())
                               for s in solo})
    if solo_flags != [[True], [False]]:
        raise AssertionError(f"safety_serve: the solo pair flagged "
                             f"{solo_flags}, not seed 1 alone")
    return run


def perturb_zero_convs(torch, bundle, seed: int) -> None:
    """Seeded non-zero weights for the bundle's zero convs (the hint
    encoder's ``conv_out`` and every ``controlnet_*`` conv): a fresh
    ControlNet adds exactly nothing."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    with torch.no_grad():
        for conv in (bundle.embed.conv_out, bundle.net.controlnet_mid_block,
                     *bundle.net.controlnet_down_blocks):
            for p in (conv.weight, conv.bias):
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=bundle.device)
                        * CN_ZERO_CONV_STD)


def canny_rgb(pixels, low: int = 100, high: int = 200):
    import cv2
    import numpy as np

    return np.stack([cv2.Canny(pixels, low, high)] * 3, axis=-1)


def control_assets() -> dict:
    """The ControlNet phases' inputs: annotated (Canny) conditioning images
    at 512 and 1024 px and a raw picture the worker's job preprocesses."""
    return {"cond-71.png": png_bytes(canny_rgb(smooth_image(71, IMG_SIZE))),
            "raw-72.png": png_bytes(smooth_image(72, IMG_SIZE)),
            "cond-73-1024.png": png_bytes(canny_rgb(smooth_image(73,
                                                                 XL_SIZE)))}


def control_job(seed: int, scale: float, model: str = CN_MODEL,
                asset: str = "/assets/cond-71.png", base=None, **block):
    base = JOBS[0] if base is None else base
    return dict(base, id=f"cn-{model.split('/')[-1]}-{seed}-{scale}",
                seed=seed, start_image_uri=asset, controlnet_scale=scale,
                parameters={"controlnet": {"controlnet_model_name": model,
                                           **block}})


def controlnet_serve_phase(torch, registry, pool, slot,
                           hive: LocalHive) -> dict:
    """A ControlNet at SD1.5's published widths (the UNet's down and mid
    trunk, bf16; its zero convs seeded), written as a diffusers-layout
    directory under the run's settings root and loaded through the
    registry (the directory exists, so no random fallback; every tensor
    equal to its source). Conditioning images are Canny edge maps fetched
    from this script's hive. Solo: serve's seeds 1 and 2 as txt2img, seed 1
    as a control job at scales 1.0, 0.5 and 0 on one map and seed 2 at 0.5
    on another (at 1024 px, resized onto the bucket); the scale-0 image bit
    for bit the txt2img image. Lanes: the two txt2img jobs admitted
    together into one adaptive lane, then the two control jobs of seeds 1
    (1.0) and 2 (0.5) likewise into a lane of the same width. A lane is
    another batch composition than a solo run, so its images are not the
    solo ones bit for bit on the card; the txt2img pair measures that
    effect, and the control pair may stray from its solo images by no more
    than ``CN_LANE_MARGIN`` beyond it (a row given the other row's hint or
    scale strays by tens of levels). Then seed 5 with two images solo and in
    a lane pinned at 2 rows, the solo run's composition: bit for bit. The
    worker: a job with an annotated ``start_image_uri`` and one with
    ``preprocess: true, type: canny`` (its ``preprocessed_input`` echo
    exactly cv2's edges of the fetched picture). Every envelope
    error-free with the ``controlnet`` stamp; B1 = 14 x control evals (10
    for the txt2img job). Prints ``generation_s`` of the control jobs
    against the txt2img job and the bundle's bytes in the ledger."""
    import numpy as np

    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.node.executor import (
        synchronous_do_work,
        synchronous_do_work_batch,
    )
    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.components import ControlNetBundle
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    fam = FAMILIES["sd15"]
    t0 = time.perf_counter()
    source = ControlNetBundle.random(fam, seed=0, device="cuda",
                                     model_name=CN_MODEL)
    perturb_zero_convs(torch, source, seed=11)
    state = {k: v.detach().cpu() for k, v in source.state_dict().items()}
    del source
    target = model_dir(CN_MODEL)
    target.mkdir(parents=True, exist_ok=True)
    save_file(state, target / "diffusion_pytorch_model.safetensors",
              {"format": "pt"})
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    bundle = registry.controlnet(CN_MODEL, fam)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    unequal = [k for k, v in bundle.state_dict().items()
               if not torch.equal(v.cpu(), state[k])]
    if unequal:
        raise AssertionError(f"controlnet_serve: {len(unequal)} tensors "
                             f"differ from their source: {unequal[:4]}")
    [ledger_bytes] = [e.bytes for k, e in registry.residency._entries.items()
                      if k[:2] == ("controlnet", CN_MODEL)]

    results: dict = {}

    def serve(phase, job, lanes):
        result = synchronous_do_work(dict(job), slot, registry)
        results[job["id"]] = (result, check_envelope(phase, job, result,
                                                     lanes))
        return result

    def twin_grid(lanes: bool) -> str:
        """The two-image job's 1x2 grid, its envelope checked."""
        result = synchronous_do_work(dict(twin), slot, registry)
        cfg = result["pipeline_config"]
        if "error" in cfg or ("stepper" in cfg) != lanes or \
                cfg.get("controlnet") != CN_MODEL:
            raise AssertionError(f"controlnet_serve twin ({lanes}): {cfg}")
        blob = result["artifacts"]["primary"]["blob"]
        if png_hw(blob) != (IMG_SIZE, 2 * IMG_SIZE):
            raise AssertionError(f"controlnet_serve twin grid {png_hw(blob)}")
        return blob

    def stamped(job_id, scale):
        cfg = results[job_id][0]["pipeline_config"]
        if cfg.get("controlnet") != CN_MODEL or \
                cfg.get("controlnet_scale") != scale:
            raise AssertionError(f"controlnet_serve {job_id}: stamps "
                                 f"{cfg.get('controlnet')}, "
                                 f"{cfg.get('controlnet_scale')}")

    kernels.reset_launches()
    plains = [dict(job, id=f"cn-txt2img-{job['seed']}") for job in JOBS[:2]]
    plain = plains[0]
    solo_jobs = [control_job(1, 1.0), control_job(1, 0.5),
                 control_job(1, 0.0),
                 control_job(2, 0.5, asset="/assets/cond-73-1024.png")]
    with env(CHIASWARM_STEPPER="0"):
        for job in plains:
            serve("controlnet_serve_solo", job, False)
        plain_launches = kernel_launches()
        check_b1("controlnet_serve_txt2img", plain_launches,
                 len(plains) * SERVE_STEPS * B1_LAUNCHES_PER_UNET_EVAL)
        for job in on_hive(hive, solo_jobs):
            serve("controlnet_serve_solo", job, False)
            stamped(job["id"], job["controlnet_scale"])
        solo_launches = {k: v - plain_launches[k]
                         for k, v in kernel_launches().items()}
        check_b1("controlnet_serve_solo", solo_launches,
                 len(solo_jobs) * SERVE_STEPS * B1_LAUNCHES_PER_CONTROL_EVAL)
    txt2img = decode_png(results[plain["id"]][1])
    zero = decode_png(results[solo_jobs[2]["id"]][1])
    one = decode_png(results[solo_jobs[0]["id"]][1])
    scale_zero_equal = bool((zero == txt2img).all())
    steered = int(np.abs(one.astype(int) - txt2img.astype(int)).max())

    plain_pair = [dict(job, id=f"cn-txt2img-lane-{job['seed']}")
                  for job in plains]
    pair = on_hive(hive, [dict(job, id=f"cn-lane-{job['seed']}")
                          for job in (solo_jobs[0], solo_jobs[3])])
    twin = on_hive(hive, [dict(control_job(5, 1.0), id="cn-twin-5",
                               num_images_per_prompt=2)])[0]
    with env(CHIASWARM_STEPPER="0"):
        mark = kernel_launches()
        twin_solo = twin_grid(False)
        twin_launches = {k: v - mark[k] for k, v in kernel_launches().items()}
        check_b1("controlnet_serve_twin", twin_launches,
                 SERVE_STEPS * B1_LAUNCHES_PER_CONTROL_EVAL)

    def lane_pair(jobs: list, per_step: int) -> tuple[int, dict, set]:
        """``jobs`` admitted together into one fresh adaptive lane: its
        steps, its B1 launches (``per_step`` a lane step) and the lanes'
        (id, width)."""
        get_stepper(slot).shutdown()
        before, mark = stepper_stats(slot), kernel_launches()
        with lane_admissions(hold={job["id"]: 0 for job in jobs}):
            done = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                             registry)
        for result, job in zip(done, jobs):
            results[job["id"]] = (result, check_envelope(
                "controlnet_serve_lanes", job, result, True))
        steps = delta(stepper_stats(slot), before, "steps_executed")
        get_stepper(slot).shutdown()
        launches = {k: v - mark[k] for k, v in kernel_launches().items()}
        check_b1("controlnet_serve_lanes", launches, steps * per_step)
        return steps, launches, {
            (r["pipeline_config"]["stepper"]["lane"],
             r["pipeline_config"]["stepper"]["lane_width"]) for r in done}

    with env(CHIASWARM_STEPPER="1"):
        _, _, plain_lanes = lane_pair(plain_pair, B1_LAUNCHES_PER_UNET_EVAL)
        steps, lane_launches, lanes = lane_pair(
            pair, B1_LAUNCHES_PER_CONTROL_EVAL)
        for job in pair:
            stamped(job["id"], job["controlnet_scale"])
        witness = image_diffs(
            {job["seed"]: results[job["id"]][1] for job in plain_pair},
            {job["seed"]: results[job["id"]][1] for job in plains})
        vs_solo = image_diffs(
            {job["seed"]: results[job["id"]][1] for job in pair},
            {job["seed"]: results[job["id"]][1]
             for job in (solo_jobs[0], solo_jobs[3])})
    with env(CHIASWARM_STEPPER="1", CHIASWARM_STEPPER_LANE_WIDTH="2"):
        get_stepper(slot).shutdown()
        before, mark = stepper_stats(slot), kernel_launches()
        twin_equal = twin_grid(True) == twin_solo
        twin_steps = delta(stepper_stats(slot), before, "steps_executed")
        get_stepper(slot).shutdown()
        check_b1("controlnet_serve_twin_lane",
                 {k: v - mark[k] for k, v in kernel_launches().items()},
                 twin_steps * B1_LAUNCHES_PER_CONTROL_EVAL)
    with env(CHIASWARM_STEPPER="1"):
        worker_jobs = on_hive(hive, [
            dict(control_job(3, 1.0), id="cn-worker-annotated"),
            dict(control_job(4, 1.0, asset="/assets/raw-72.png",
                             preprocess=True, type="canny"),
                 id="cn-worker-preprocess")])
        before, mark = stepper_stats(slot), kernel_launches()
        serve_through_worker(hive, pool, registry, worker_jobs)
        steps_w = delta(stepper_stats(slot), before, "steps_executed")
        get_stepper(slot).shutdown()
        worker_launches = {k: v - mark[k]
                           for k, v in kernel_launches().items()}
        check_b1("controlnet_serve_worker", worker_launches,
                 steps_w * B1_LAUNCHES_PER_CONTROL_EVAL)
    by_id = {r["id"]: r for r in hive.results}
    for job in worker_jobs:
        result = by_id[job["id"]]
        results[job["id"]] = (result, check_envelope(
            "controlnet_serve_worker", job, result, True))
        stamped(job["id"], 1.0)
    echo = by_id["cn-worker-preprocess"]["artifacts"].get(
        "preprocessed_input")
    edges = canny_rgb(smooth_image(72, IMG_SIZE))
    echo_exact = echo is not None and bool(
        (decode_png(echo["blob"]) == edges).all())
    if "preprocessed_input" in by_id["cn-worker-annotated"]["artifacts"]:
        raise AssertionError("controlnet_serve: an echo without preprocess")
    run = launched()
    gen_s = {job_id: r["pipeline_config"]["generation_s"]
             for job_id, (r, _) in results.items()}
    control_s = [gen_s[j["id"]] for j in solo_jobs]
    stray = {"max": max(d["max"] for d in vs_solo.values())
             - max(d["max"] for d in witness.values()),
             "within_one": min(d["within_one"] for d in witness.values())
             - min(d["within_one"] for d in vs_solo.values())}
    emit("controlnet_serve", write_s=write_s, load_s=load_s,
         param_bytes=bundle.param_bytes(), ledger_bytes=ledger_bytes,
         dtype=str(bundle.dtype), generation_s=gen_s,
         control_over_txt2img=statistics.median(control_s)
         / gen_s[plain["id"]],
         scale_zero_bit_equal_txt2img=scale_zero_equal,
         scale_one_max_diff_from_txt2img=steered, lane_steps=steps,
         lanes=sorted(lanes), txt2img_lanes=sorted(plain_lanes),
         lane_vs_solo=vs_solo, txt2img_lane_vs_solo=witness,
         lane_stray_beyond_txt2img=stray, lane_margin=CN_LANE_MARGIN,
         twin_bit_equal=twin_equal, twin_lane_steps=twin_steps,
         worker_lane_steps=steps_w,
         echo_is_the_canny_edges=echo_exact,
         launches={"txt2img": plain_launches, "solo": solo_launches,
                   "lanes": lane_launches, "worker": worker_launches})
    if not scale_zero_equal:
        raise AssertionError("controlnet_serve: the scale-0 image is not the "
                             "txt2img image bit for bit")
    if steered == 0:
        raise AssertionError("controlnet_serve: scale 1.0 changed nothing")
    if len(lanes) != 1 or len(plain_lanes) != 1 or \
            {w for _, w in lanes} != {w for _, w in plain_lanes}:
        raise AssertionError(f"controlnet_serve: the control pair rode lanes "
                             f"{lanes}, the txt2img pair {plain_lanes}")
    if stray["max"] > CN_LANE_MARGIN["max"] or \
            stray["within_one"] > CN_LANE_MARGIN["within_one"]:
        raise AssertionError(f"controlnet_serve: the control pair's lane "
                             f"images {vs_solo} stray from their solo images "
                             f"beyond the txt2img pair's {witness}")
    if not twin_equal:
        raise AssertionError("controlnet_serve: the two-image job's lane "
                             "image is not its solo image bit for bit")
    if not echo_exact:
        raise AssertionError("controlnet_serve: the preprocessed_input echo "
                             "is not the Canny edges of the fetched image")
    return run


def xl_controlnet_serve_phase(torch, registry, slot,
                              hive: LocalHive) -> dict:
    """An SDXL ControlNet (random through the registry, its zero convs then
    seeded in place): xl_serve's seed 1 at 1024 px as txt2img and as a
    control job on a Canny map, solo. B1 = 70 x 20 and 104 x 20; the
    control envelope stamped. Prints both jobs' ``generation_s``."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.ops import kernels

    bundle = registry.controlnet(XL_CN_MODEL, FAMILIES["sdxl"])
    perturb_zero_convs(torch, bundle, seed=12)
    plain = dict(XL_JOBS[0], id="xl-cn-txt2img-1")
    job = on_hive(hive, [control_job(1, 1.0, XL_CN_MODEL,
                                     "/assets/cond-73-1024.png",
                                     base=XL_JOBS[0])])[0]
    kernels.reset_launches()
    with env(CHIASWARM_STEPPER="0"):
        from chiaswarm_tpu_torch.node.executor import synchronous_do_work

        ref = synchronous_do_work(dict(plain), slot, registry)
        check_envelope("xl_controlnet_serve", plain, ref, False)
        mark = kernel_launches()
        check_b1("xl_controlnet_serve_txt2img", mark,
                 SERVE_STEPS * B1_LAUNCHES_PER_XL_EVAL)
        result = synchronous_do_work(dict(job), slot, registry)
        check_envelope("xl_controlnet_serve", job, result, False)
    launches = {k: v - mark[k] for k, v in kernel_launches().items()}
    cfg = result["pipeline_config"]
    emit("xl_controlnet_serve", param_bytes=bundle.param_bytes(),
         generation_s=cfg["generation_s"],
         txt2img_generation_s=ref["pipeline_config"]["generation_s"],
         control_over_txt2img=cfg["generation_s"]
         / ref["pipeline_config"]["generation_s"],
         launches=launches,
         expected_flash_launches=SERVE_STEPS
         * B1_LAUNCHES_PER_XL_CONTROL_EVAL)
    check_b1("xl_controlnet_serve", launches,
             SERVE_STEPS * B1_LAUNCHES_PER_XL_CONTROL_EVAL)
    if cfg.get("controlnet") != XL_CN_MODEL:
        raise AssertionError(f"xl_controlnet_serve: stamp {cfg}")
    return launched()


# ---- instruct-pix2pix, the x2 upscale pass, LoRA and textual inversion ---

# the learned ControlNet preprocessors: (class, published file, seed,
# options) at their published widths, and the serve phase's modes
PREPROCESS_STEPS = 4    # per served job: B1 is held per control eval
STANDIN_MODES = ("scribble", "softedge", "depth", "normal", "normalbae",
                 "seg", "mlsd", "lineart")
LEARNED_MODES = STANDIN_MODES + ("openpose",)
CONTINUOUS_MAPS = {"hed", "lineart", "dpt"}  # the others threshold
PREPROCESS_WITHIN_ONE = 0.99  # share of a continuous map within one level
PREPROCESS_PAIR = ("depth", "seg")   # the detector jobs sharing a lane
# DPT's last conv feeds a ReLU: PyTorch's default draw of its one bias can
# leave the whole depth map 0 (the seed's does), so it is set positive
DPT_HEAD_BIAS = 0.1


def detector_specs() -> dict:
    """Each detector's (class, published file, seed, options, conv depth)
    at its published widths: HED and M-LSD on 512 px canvases, lineart
    with 3 blocks on a 512 px canvas, body-pose at a 368 px box, DPT-Large
    (ViT-L/16 at 384 px), UperNet-ConvNeXt-small at 512 px."""
    from chiaswarm_tpu_torch.models import dpt, hed, lineart, mlsd
    from chiaswarm_tpu_torch.models import openpose, upernet

    small = upernet.UPERNET_CONVNEXT_SMALL
    return {
        "hed": (hed.HEDDetector, "ControlNetHED.pth", 81, {},
                hed.CONV_DEPTH),
        "mlsd": (mlsd.MLSDDetector, "mlsd_large_512_fp32.pth", 82, {},
                 mlsd.CONV_DEPTH),
        "lineart": (lineart.LineartDetector, "sk_model.pth", 83,
                    {"n_blocks": 3}, lineart.conv_depth(3)),
        "openpose": (openpose.OpenposeDetector, "body_pose_model.pth", 84,
                     {}, openpose.CONV_DEPTH),
        "dpt": (dpt.DPTDetector, "model.safetensors", 85,
                {"config": dpt.DPT_LARGE}, dpt.CONV_DEPTH),
        "upernet": (upernet.UperNetDetector, "model.safetensors", 86,
                    {"config": small}, upernet.conv_depth(small)),
    }


def published_file_state(torch, name: str, state: dict) -> dict:
    """A detector's state dict in its published file's layout: body-pose's
    convs without their stage module; DPT's snapshot with the final
    ``dpt.layernorm`` and the first fusion layer's unused residual unit,
    UperNet's with an auxiliary FCN head (keys both packages drop)."""
    gen = torch.Generator().manual_seed(len(name))
    if name == "openpose":
        return {k.split(".", 1)[1]: v for k, v in state.items()}
    extra = {}
    if name == "dpt":
        extra = {"dpt.layernorm.weight": (1024,), "dpt.layernorm.bias": (1024,),
                 **{f"neck.fusion_stage.layers.0.residual_layer1.convolution"
                    f"{i}.{leaf}": (256, 256, 3, 3) if leaf == "weight"
                    else (256,) for i in (1, 2) for leaf in ("weight", "bias")}}
    elif name == "upernet":
        extra = {"auxiliary_head.convs.0.conv.weight": (256, 384, 3, 3),
                 **{f"auxiliary_head.convs.0.batch_norm.{leaf}": (256,)
                    for leaf in ("weight", "bias", "running_mean",
                                 "running_var")},
                 "auxiliary_head.classifier.weight": (150, 256, 1, 1),
                 "auxiliary_head.classifier.bias": (150,)}
    return {**state, **{k: torch.randn(shape, generator=gen) * 0.02
                        for k, shape in extra.items()}}


def host_split(fn, iters: int = 5) -> float:
    """Median host-clock ms of ``fn`` (numpy and cv2 work)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def preprocess_check_phase(torch) -> dict:
    """The six ControlNet detectors at their published widths
    (``detector_specs``), each with PyTorch's default initialisation drawn
    from its seed on the CPU (DPT's last bias ``DPT_HEAD_BIAS``), written
    under ``<settings root>/models/<name>`` in its published file's layout
    (``published_file_state``) and loaded on the card through its
    ``from_checkpoint``: every tensor equal to its
    source, the file's dropped keys absent. On one 512x512 picture
    (``smooth_image(72)``, the serve phase's), each detector's network
    output on the card against the same detector on the CPU, within
    ``tf32_bar`` of its conv depth (cuDNN's TF32 on, PyTorch's default;
    UperNet's logits, the others' host outputs); then the final maps, the
    card's from the card's output through the host post-processing: a
    continuous map (HED, lineart, DPT) with ``PREPROCESS_WITHIN_ONE`` of
    its pixels within one level of the CPU's; a threshold map's (M-LSD,
    UperNet, body-pose) agreement and non-zero share printed (random
    weights may leave it empty). No kernel of the port is launched. Prints
    each detector's write and load seconds, bytes on the card, the
    network's device ms (CUDA events, median of 20), the detector's ms
    with its upload and download (host clock), the host ms of preparing
    the input and of the post-processing (median of 5)."""
    import numpy as np

    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.models.annotator import tf32_bar, upload_nhwc
    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    kernels.reset_launches()
    picture = smooth_image(72, IMG_SIZE)
    rows, failures = {}, []
    for name, (cls, file, seed, opts, depth) in detector_specs().items():
        t0 = time.perf_counter()
        cpu = cls.random(seed, "cpu", **opts)
        if name == "dpt":  # a ReLU'd depth all 0 under the drawn head
            with torch.no_grad():
                cpu.net.head.head[4].bias.fill_(DPT_HEAD_BIAS)
        source = {k: v for k, v in cpu.net.state_dict().items()}
        on_disk = published_file_state(torch, name, source)
        target = model_dir(name)
        target.mkdir(parents=True, exist_ok=True)
        if file.endswith(".safetensors"):
            save_file(on_disk, target / file, {"format": "pt"})
        else:
            torch.save(on_disk, target / file)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = cls.from_checkpoint(target, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = card.net.state_dict()
        unequal = [k for k, v in loaded.items()
                   if not torch.equal(v.cpu(), source[k])]
        dropped = sorted(set(on_disk) - set(source))
        if unequal or set(loaded) != set(source) or \
                any(k in loaded for k in dropped):
            raise AssertionError(f"preprocess_check {name}: {len(unequal)} "
                                 f"tensors differ from their source "
                                 f"({unequal[:3]}), dropped {dropped[:3]}")
        x, ctx = card.prepare(picture)
        t_x = upload_nhwc(x, card.device)
        with torch.inference_mode():
            if name == "upernet":  # the logits: the argmax leaves a map
                want = [cpu.net(torch.from_numpy(x).permute(0, 3, 1, 2)
                                .contiguous()).numpy()]
                got = [card.net(t_x).cpu().numpy()]
            else:
                want, got = cpu.forward(x), card.forward(x)
            net_ms = time_ms(torch, lambda: card.net(t_x))
        if name == "upernet":  # the CPU's argmax from its logits
            cpu_out = want[0][0].argmax(0).astype(np.uint8)
            card_out = card.forward(x)
        else:
            cpu_out, card_out = want, got
        want = [np.asarray(w) for w in (want if isinstance(want, (list, tuple))
                                        else [want])]
        got = [np.asarray(g) for g in (got if isinstance(got, (list, tuple))
                                       else [got])]
        scale = max(float(np.abs(w).max()) for w in want)
        rel = max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
            / max(scale, 1e-30)
        card_map = card.finish(card_out, ctx).astype(np.int16)
        cpu_map = cpu.finish(cpu_out, ctx).astype(np.int16)
        diff = np.abs(card_map - cpu_map)
        row = {
            "params": sum(p.numel() for p in card.net.parameters()),
            "param_bytes": card.param_bytes(), "write_s": write_s,
            "load_s": load_s, "file_bytes": sum(
                f.stat().st_size for f in target.iterdir()),
            "dropped_keys": len(dropped), "net_ms": net_ms,
            "detector_ms": host_split(lambda: card.forward(x)),
            "prepare_ms": host_split(lambda: card.prepare(picture)),
            "post_ms": host_split(lambda: card.finish(card_out, ctx)),
            "output_scale": scale, "rel_err_vs_cpu": rel,
            "bar": tf32_bar(depth), "conv_depth": depth,
            "map_equal_share": float((diff == 0).mean()),
            "map_within_one_share": float((diff <= 1).mean()),
            "map_max_diff": int(diff.max()),
            "map_nonzero_share": float((card_map != 0).any(axis=-1).mean()
                                       if card_map.ndim == 3
                                       else (card_map != 0).mean()),
            "continuous": name in CONTINUOUS_MAPS}
        rows[name] = row
        if not (scale > 0 and rel <= row["bar"]):
            failures.append(f"{name}: network output {rel} of its scale "
                            f"{scale} from the CPU's (bar {row['bar']})")
        if row["continuous"] and \
                row["map_within_one_share"] < PREPROCESS_WITHIN_ONE:
            failures.append(f"{name}: {row['map_within_one_share']} of the "
                            "map within one level of the CPU's")
        del cpu, card
        torch.cuda.empty_cache()
    launches = kernel_launches()
    emit("preprocess_check", wall_s=time.perf_counter() - t_phase,
         detectors=rows,
         param_bytes_all=sum(r["param_bytes"] for r in rows.values()),
         launches=launches, tf32=torch.backends.cudnn.allow_tf32,
         nvidia_smi=nvidia_smi_line())
    if any(launches.values()):
        raise AssertionError(f"preprocess_check launched {launches}")
    if failures:
        raise AssertionError(f"preprocess_check: {failures}")
    return rows


def preprocess_serve_phase(torch, registry, slot, hive: LocalHive) -> dict:
    """ControlNet jobs with ``preprocess: true`` at 512 px (``PREPROCESS_STEPS``
    steps, SD1.5 and controlnet_serve's ControlNet), their picture
    (``raw-72.png``) fetched from this script's hive, through
    ``synchronous_do_work`` on the solo path. First with the detector
    directories moved aside and the cache cleared: one job for each
    stand-in mode, and the openpose job's fatal envelope naming its
    directory. Then with the directories back and the cache cleared: one
    job for each of the nine learned modes (each detector loaded on the
    card by its first job), and ``PREPROCESS_PAIR`` admitted together into
    one adaptive lane. Gates: every envelope error-free with a 512x512 PNG
    and the ``controlnet`` stamp; its ``preprocessed_input`` echo exactly
    the port's own map of the fetched picture (``preprocess_image`` on the
    card again: the stand-in's map, or the host post-processing of the
    card's network output); B1 = 14 x control evals and no other kernel.
    Prints, a mode, the preprocess seconds (that call, host clock) against
    the job's ``generation_s``."""
    import numpy as np
    from PIL import Image

    from chiaswarm_tpu_torch.node.executor import (
        synchronous_do_work,
        synchronous_do_work_batch,
    )
    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper
    from chiaswarm_tpu_torch.workloads import controlnet as tcontrol

    t_phase = time.perf_counter()
    picture = smooth_image(72, IMG_SIZE)
    names = list(detector_specs())
    aside = settings_root_dir() / "detectors-aside"
    aside.mkdir(parents=True, exist_ok=True)
    for name in names:
        model_dir(name).rename(aside / name)
    tcontrol.clear_detectors()
    kernels.reset_launches()
    modes: dict = {}

    def job_for(mode: str, stage: str, seed: int) -> dict:
        return on_hive(hive, [dict(
            control_job(seed, 1.0, asset="/assets/raw-72.png",
                        preprocess=True, type=mode),
            id=f"pre-{stage}-{mode}", num_inference_steps=PREPROCESS_STEPS)])[0]

    def held(stage: str, mode: str, job: dict, result: dict,
             lanes: bool) -> None:
        check_envelope(f"preprocess_serve_{stage}", job, result, lanes)
        cfg = result["pipeline_config"]
        if cfg.get("controlnet") != CN_MODEL:
            raise AssertionError(f"preprocess_serve {job['id']}: {cfg}")
        echo = result["artifacts"].get("preprocessed_input")
        t0 = time.perf_counter()
        own = np.asarray(tcontrol.preprocess_image(
            Image.fromarray(picture), {"preprocess": True, "type": mode},
            "cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        equal = echo is not None and bool(
            (decode_png(echo["blob"]) == own).all())
        modes[f"{stage}:{mode}"] = {
            "preprocess_s": seconds, "generation_s": cfg["generation_s"],
            "preprocess_over_generation": seconds / cfg["generation_s"],
            "echo_is_own_map": equal,
            "map_nonzero_share": float((own != 0).any(axis=-1).mean()),
            "stepper": cfg.get("stepper")}
        if not equal:
            raise AssertionError(f"preprocess_serve {job['id']}: the echo is "
                                 "not the port's own map of the picture")

    with env(CHIASWARM_STEPPER="0"):
        for i, mode in enumerate(STANDIN_MODES):
            job = job_for(mode, "standin", 40 + i)
            held("standin", mode, job,
                 synchronous_do_work(dict(job), slot, registry), False)
        standin_launches = kernel_launches()
        check_b1("preprocess_serve_standins", standin_launches,
                 len(STANDIN_MODES) * PREPROCESS_STEPS
                 * B1_LAUNCHES_PER_CONTROL_EVAL)
        refused = synchronous_do_work(job_for("openpose", "standin", 48),
                                      slot, registry)
        error = str(refused["pipeline_config"].get("error", ""))
        if not refused.get("fatal_error") or \
                str(model_dir("openpose")) not in error or \
                kernel_launches() != standin_launches:
            raise AssertionError(f"preprocess_serve: openpose without "
                                 f"weights gave {refused['pipeline_config']}")
    standins = dict(tcontrol._DETECTORS)
    if set(standins.values()) != {None}:
        raise AssertionError(f"preprocess_serve: detectors {standins} "
                             "without their directories")

    tcontrol.clear_detectors()
    for name in names:
        (aside / name).rename(model_dir(name))
    with env(CHIASWARM_STEPPER="0"):
        mark = kernel_launches()
        for i, mode in enumerate(LEARNED_MODES):
            job = job_for(mode, "detector", 50 + i)
            held("detector", mode, job,
                 synchronous_do_work(dict(job), slot, registry), False)
        detector_launches = {k: v - mark[k]
                             for k, v in kernel_launches().items()}
        check_b1("preprocess_serve_detectors", detector_launches,
                 len(LEARNED_MODES) * PREPROCESS_STEPS
                 * B1_LAUNCHES_PER_CONTROL_EVAL)
    loaded = {k[0]: str(det.device) for k, det in tcontrol._DETECTORS.items()
              if det is not None}
    if sorted(loaded) != sorted(names) or \
            any(not d.startswith("cuda") for d in loaded.values()):
        raise AssertionError(f"preprocess_serve: detectors on {loaded}")
    detector_bytes = sum(det.param_bytes()
                         for det in tcontrol._DETECTORS.values())

    pair = [job_for(mode, "lane", 60 + i)
            for i, mode in enumerate(PREPROCESS_PAIR)]
    with env(CHIASWARM_STEPPER="1"):
        get_stepper(slot).shutdown()
        before, mark = stepper_stats(slot), kernel_launches()
        with lane_admissions(hold={job["id"]: 0 for job in pair}):
            done = synchronous_do_work_batch([dict(j) for j in pair], slot,
                                             registry)
        steps = delta(stepper_stats(slot), before, "steps_executed")
        get_stepper(slot).shutdown()
        lane_launches = {k: v - mark[k] for k, v in kernel_launches().items()}
        check_b1("preprocess_serve_lane", lane_launches,
                 steps * B1_LAUNCHES_PER_CONTROL_EVAL)
    for mode, job, result in zip(PREPROCESS_PAIR, pair, done):
        held("lane", mode, job, result, True)
    lanes = {(r["pipeline_config"]["stepper"]["lane"],
              r["pipeline_config"]["stepper"]["lane_width"]) for r in done}
    run = launched()
    emit("preprocess_serve", wall_s=time.perf_counter() - t_phase,
         steps=PREPROCESS_STEPS, modes=modes,
         lane_steps=steps, lanes=sorted(lanes), detectors_on=loaded,
         detector_bytes=detector_bytes, openpose_refusal=error,
         launches={"standins": standin_launches,
                   "detectors": detector_launches, "lane": lane_launches},
         b1_shapes=b1_shapes(run), nvidia_smi=nvidia_smi_line())
    if len(lanes) != 1:
        raise AssertionError(f"preprocess_serve: the pair rode lanes {lanes}")
    tcontrol.clear_detectors()
    torch.cuda.empty_cache()
    return run


P2P_MODEL = "timbrooks/instruct-pix2pix"  # the hive's name for pix2pix
# strength 0.3 and 0.6 -> image guidance 1.5 and 3.0 (the formatter's x5)
P2P_STRENGTHS = {61: 0.3, 62: 0.6}
P2P_JOBS = [dict(JOBS[0], id=f"p2p-{seed}", seed=seed, model_name=P2P_MODEL,
                 prompt="turn it into a snowy winter scene", strength=s,
                 start_image_uri=f"/assets/init-{seed}.png")
            for seed, s in P2P_STRENGTHS.items()]
UPSCALER = "stabilityai/sd-x2-latent-upscaler"  # the callback's default
UPSCALE_STEPS = 20  # the reference's upscale pass (swarm/diffusion/upscale.py)
UPSCALE_JOB = dict(JOBS[0], id="upscale-sd15-1",
                   parameters={"upscale": True})
XL_UPSCALE_JOB = dict(XL_JOBS[0], id="upscale-sdxl-1",
                      parameters={"upscale": True})
LORA_RANK = 4
LORA_MODEL = "chip-smoke/lora-attn-procs"
LORA_PEFT_MODEL = "chip-smoke/lora-peft"
TI_MODEL = "chip-smoke/concept"
TI_TOKEN = "<chip-smoke>"


def upscaler_b1_per_eval() -> int:
    """B1's launches in one eval of the x2 upscaler's UNet, from its config:
    a spatial self-attention per transformer block, down (``layers_per_block``
    a level), mid (one) and up (one more a level), at every level with a
    transformer; every level's grid has at least 1,024 tokens at the served
    sizes, so each goes to B1. (1, 1, 1) at depth 1: 6 + 1 + 9 = 16."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES

    unet = FAMILIES["upscaler_x2"].unet
    levels = [d for d in unet.transformer_depth if d]
    per_block = sum(d * (2 * unet.layers_per_block + 1) for d in levels)
    return per_block + unet.transformer_depth[-1]


def tiles_for(latent: int, tile: int = 64, overlap: int = 8) -> int:
    """The tiles ``tiled_decode`` decodes for a square latent."""
    if latent <= tile:
        return 1
    return max(1, -(-(latent - overlap) // (tile - overlap))) ** 2


def write_model(torch, family: str, name: str, seed: int) -> dict:
    """A model of ``family`` at its published widths, random from ``seed``
    on the card, written as a diffusers-layout directory of ``name`` under
    the run's settings root at its serving dtypes; returns its tensors (on
    the host) by module and the write's seconds and bytes."""
    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.pipelines.components import Components

    t0 = time.perf_counter()
    source = Components.random(family, seed=seed, device="cuda",
                               model_name=name)
    info = write_checkpoint(torch, source, model_dir(name), float32=False)
    states = {m: {k: v.detach().cpu() for k, v in p.items()}
              for m, p in module_states(source).items()}
    del source
    torch.cuda.empty_cache()
    return {"states": states, "write_s": time.perf_counter() - t0,
            "bytes": info["bytes"]}


def check_loaded(torch, phase: str, pipe, states: dict) -> None:
    """Every loaded tensor of ``pipe`` equal to its source."""
    unequal = [f"{m}.{k}" for m, params in module_states(pipe.c).items()
               for k, v in params.items()
               if not torch.equal(v.detach().cpu(), states[m][k])]
    if unequal:
        raise AssertionError(f"{phase}: {len(unequal)} loaded tensors differ "
                             f"from their source: {unequal[:4]}")


def b1_shapes(run: dict) -> list:
    return [[*k, n] for k, n in run["flash_attention"]["shapes"].items()]


def pix2pix_serve_phase(torch, registry, pool, slot) -> dict:
    """instruct-pix2pix at its published widths (SD1.5's UNet with an
    8-channel ``conv_in``, bf16, random from seed 0) written as a
    diffusers-layout directory under ``timbrooks__instruct-pix2pix`` and
    loaded through the registry with no random fallback (every tensor equal
    to its source). One tripled-batch UNet eval (3 x 8 x 64 x 64, B1's
    route) against the same weights in float32 on the plain route, relative
    L2 3e-2. Two jobs through the worker, their 512 px pictures fetched from
    this script's hive, strengths 0.3 and 0.6: PNGs of the input's size,
    ``mode: pix2pix`` and ``image_guidance_scale`` 1.5 and 3.0 stamped, no
    lane (the lanes are on), B1 = 10 x 20 a job, all at the tripled batch;
    the first job again through ``synchronous_do_work``, bit for bit."""
    import copy

    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    written = write_model(torch, "pix2pix", P2P_MODEL, seed=0)
    t0 = time.perf_counter()
    pipe = registry.pipeline(P2P_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check_loaded(torch, "pix2pix_serve", pipe, written["states"])
    if tuple(pipe.c.unet.conv_in.weight.shape) != (320, 8, 3, 3):
        raise AssertionError(f"pix2pix conv_in {pipe.c.unet.conv_in.weight.shape}")

    # one tripled-batch eval: bf16 through B1 against float32 plain
    gen = torch.Generator(device="cpu").manual_seed(61)
    x = torch.randn((3, 8, 64, 64), generator=gen).cuda()
    ctx = torch.randn((3, 77, 768), generator=gen).cuda()
    t = torch.tensor([999.0, 999.0, 999.0], device="cuda")
    unet32 = copy.deepcopy(pipe.c.unet)
    cast_module(unet32, torch.float32)
    set_attn_impl(unet32, "xla")
    kernels.reset_launches()
    with torch.inference_mode():
        out = pipe.c.unet(x.to(torch.bfloat16), t,
                          ctx.to(torch.bfloat16)).float()
        eval_launches = kernel_launches()
        ref = unet32(x, t, ctx).float()
    del unet32
    torch.cuda.empty_cache()
    rel = float((out - ref).norm() / ref.norm())
    check_b1("pix2pix_check", eval_launches, B1_LAUNCHES_PER_UNET_EVAL)
    if not rel <= 3e-2:
        raise AssertionError(f"pix2pix_check: relative L2 {rel} (bar 3e-2)")

    with LocalHive() as hive:
        hive.assets.update({f"init-{seed}.png": png_bytes(
            smooth_image(seed, IMG_SIZE)) for seed in P2P_STRENGTHS})
        jobs = on_hive(hive, P2P_JOBS)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        worker = serve_through_worker(hive, pool, registry, jobs)
        run, launches = launched(), kernel_launches()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
        again = synchronous_do_work(dict(jobs[0]), slot, registry)
    blobs, configs = {}, {}
    for job in P2P_JOBS:
        result = by_id[job["id"]]
        blobs[job["id"]] = check_envelope("pix2pix_serve", job, result, False)
        cfg = configs[job["id"]] = result["pipeline_config"]
        want_ig = P2P_STRENGTHS[job["seed"]] * 5
        if cfg.get("mode") != "pix2pix" or \
                abs(cfg.get("image_guidance_scale", 0) - want_ig) > 1e-9:
            raise AssertionError(f"pix2pix_serve {job['id']}: {cfg}")
    repeat = check_envelope("pix2pix_serve", P2P_JOBS[0], again, False)
    shapes = run["flash_attention"]["shapes"]
    emit("pix2pix_serve", load_s=load_s, write_s=written["write_s"],
         checkpoint_bytes=written["bytes"],
         param_bytes=pipe.c.param_bytes(),
         check={"rel_l2_vs_fp32_plain": rel, "tolerance": 3e-2,
                "b1_launches": eval_launches["flash_attention"]},
         generation_s=[c["generation_s"] for c in configs.values()],
         image_guidance_scale=[c["image_guidance_scale"]
                               for c in configs.values()],
         job_seconds=[rows[j["id"]]["seconds"] for j in P2P_JOBS],
         repeat_bit_equal=repeat == blobs[P2P_JOBS[0]["id"]],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, b1_shapes=b1_shapes(run))
    check_b1("pix2pix_serve", launches, len(P2P_JOBS) * SERVE_STEPS
             * B1_LAUNCHES_PER_UNET_EVAL)
    if any(key[0] != 3 for key in shapes):
        raise AssertionError(f"pix2pix_serve: B1 off the tripled batch: "
                             f"{shapes}")
    if repeat != blobs[P2P_JOBS[0]["id"]]:
        raise AssertionError("pix2pix_serve: the same job twice differs")
    return run


def write_upscaler(torch, registry) -> tuple:
    """The x2 upscaler at the JAX family's widths, bf16, random from seed 0,
    written under ``stabilityai__sd-x2-latent-upscaler`` and loaded through
    the registry (no random fallback; every tensor equal to its source)."""
    written = write_model(torch, "upscaler_x2", UPSCALER, seed=0)
    t0 = time.perf_counter()
    upscaler = registry.pipeline(UPSCALER)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check_loaded(torch, "upscale_serve", upscaler, written["states"])
    return upscaler, {"write_s": written["write_s"], "load_s": load_s,
                      "checkpoint_bytes": written["bytes"],
                      "param_bytes": upscaler.c.param_bytes()}


def upscale_pass(torch, upscaler, image, prompt: str, seed: int) -> dict:
    """A direct ``LatentUpscalePipeline`` call on one uint8 image: its
    output, host seconds and CUDA-event ms (the pass's span on the device
    timeline), its B1 launches by shape and its peak memory above what was
    held before it."""
    from chiaswarm_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out, cfg = upscaler(image[None], prompt=prompt, seed=seed)
    end.record()
    torch.cuda.synchronize()
    return {"image": out[0], "config": cfg,
            "seconds": time.perf_counter() - t0,
            "events_ms": start.elapsed_time(end), "run": launched(),
            "peak_bytes": torch.cuda.max_memory_allocated() - held}


def b1_share(rows: list[dict], run: dict, events_ms: float) -> dict:
    """B1's ms in a run (its launches by shape times the kernel phase's
    median ms at each shape) and that over the run's event ms."""
    ms = {shape_key(r): r["ms"] for r in rows}
    b1_ms = sum(n * ms[key]
                for key, n in run["flash_attention"]["shapes"].items())
    return {"b1_ms": b1_ms, "b1_share": b1_ms / events_ms}


def upscale_case(torch, phase: str, registry, slot, upscaler, job: dict,
                 size: int, b1_rows: list,
                 per_gen_eval: int) -> tuple[dict, dict, str]:
    """``job`` (with ``parameters.upscale``) through
    ``synchronous_do_work`` with the lanes on: a PNG of twice ``size``, the
    four upscaler keys, no lane, B1 = the generation's evals x
    ``per_gen_eval`` + 20 x ``upscaler_b1_per_eval()``; the envelope's image
    bit for bit a direct upscaler call on the job's own ``size`` px image
    (the same job without ``upscale``, solo) with its prompt and seed.
    Returns the phase's launches, the numbers it prints and the envelope's
    PNG."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels

    plain = {k: v for k, v in job.items() if k != "parameters"}
    with env(CHIASWARM_STEPPER="0"):
        base = synchronous_do_work(dict(plain), slot, registry)
    base_blob = check_envelope(phase, plain, base, False)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = synchronous_do_work(dict(job), slot, registry)
    seconds = time.perf_counter() - t0
    run, launches = launched(), kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = result["pipeline_config"]
    blob = check_envelope(phase, dict(job, height=2 * size, width=2 * size),
                          result, False)
    want = {"upscaler": UPSCALER, "scale": 2, "upscale_steps": UPSCALE_STEPS}
    if any(cfg.get(k) != v for k, v in want.items()) or \
            "upscale_scheduler" not in cfg:
        raise AssertionError(f"{phase}: config {cfg}")
    per_eval = upscaler_b1_per_eval()
    check_b1(phase, launches, SERVE_STEPS * per_gen_eval
             + UPSCALE_STEPS * per_eval)
    direct = upscale_pass(torch, upscaler,
                          decode_png(base_blob).astype("uint8"),
                          job["prompt"], job["seed"])
    check_b1(f"{phase}_direct", {k: v["launches"] for k, v in
                                 direct["run"].items()},
             UPSCALE_STEPS * per_eval)
    got = decode_png(blob)
    equal = bool((got == direct["image"].astype("int16")).all())
    numbers = {"job_seconds": seconds, "generation_s": cfg["generation_s"],
               "upscale_s": direct["seconds"],
               "upscale_events_ms": direct["events_ms"],
               **b1_share(b1_rows, direct["run"], direct["events_ms"]),
               "upscale_peak_bytes": direct["peak_bytes"],
               "job_max_memory_allocated": peak,
               "upscale_scheduler": cfg["upscale_scheduler"],
               "b1_per_upscaler_eval": per_eval,
               "envelope_equals_direct_call": equal,
               "launches": launches, "b1_shapes": b1_shapes(run),
               "direct_b1_shapes": b1_shapes(direct["run"])}
    if not equal:
        raise AssertionError(f"{phase}: the envelope's image is not the "
                             "direct upscaler call's bit for bit")
    return run, numbers, blob


def upscale_serve_phase(torch, registry, pool, slot,
                        b1_rows: list) -> dict:
    """The x2 upscale pass after an SD1.5 512 px job (serve's seed 1 with
    ``parameters.upscale``): the upscaler written and loaded
    (``write_upscaler``), the job through ``synchronous_do_work`` with the
    lanes on (``upscale_case``: a 1024x1024 PNG, the upscaler keys, no
    lane, B1 = 10 x 20 + 16 x 20, the image bit for bit a direct call on
    the job's own 512 px image) and through the worker (bit for bit the
    same). Prints ``generation_s``, the pass's seconds and event ms, B1's
    share of them and the peak memory."""
    upscaler, load = write_upscaler(torch, registry)
    run, numbers, blob = upscale_case(
        torch, "upscale_serve", registry, slot, upscaler, UPSCALE_JOB,
        IMG_SIZE, b1_rows, B1_LAUNCHES_PER_UNET_EVAL)
    with LocalHive() as hive:
        serve_through_worker(hive, pool, registry, [UPSCALE_JOB])
        result = hive.results[-1]
    worker_blob = check_envelope(
        "upscale_serve_worker", dict(UPSCALE_JOB, height=2 * IMG_SIZE,
                                     width=2 * IMG_SIZE), result, False)
    emit("upscale_serve", **load, **numbers,
         worker_equals_executor=worker_blob == blob)
    if worker_blob != blob:
        raise AssertionError("upscale_serve: the worker's image is not the "
                             "executor's bit for bit")
    return run


def xl_upscale_serve_phase(torch, registry, slot, b1_rows: list) -> dict:
    """SDXL's seed 1 at 1024 px with ``parameters.upscale`` (the upscaler of
    upscale_serve): a 2048x2048 PNG decoded through ``tiled_decode``
    (256x256 latents: 25 tiles of 64 with an overlap of 8), B1 = 70 x 20 +
    16 x 20, the image bit for bit a direct call on the job's own image.
    Then a latent of exactly one tile (64x64) decodes bit for bit like the
    untiled decode. Prints the numbers upscale_serve prints and the tiles
    counted by the decoder's calls."""
    from chiaswarm_tpu_torch.models.vae import tiled_decode

    upscaler = registry.pipeline(UPSCALER)
    vae = upscaler.c.vae
    calls = []
    real = vae.decode

    def counted(z):
        calls.append(tuple(z.shape))
        return real(z)

    vae.decode = counted
    try:
        run, numbers, _ = upscale_case(
            torch, "xl_upscale_serve", registry, slot, upscaler,
            XL_UPSCALE_JOB, XL_SIZE, b1_rows, B1_LAUNCHES_PER_XL_EVAL)
    finally:
        del vae.decode
    want_tiles = tiles_for(2 * XL_SIZE // vae.config.downscale)
    # the job's decode and the direct call's: the same tiles twice
    tiles = len(calls) // 2
    z = torch.randn((1, 4, 64, 64), generator=torch.Generator().manual_seed(
        5)).cuda()
    with torch.inference_mode():
        one_tile = bool(torch.equal(tiled_decode(vae, z), vae.decode(z)
                                    .float()))
    emit("xl_upscale_serve", **numbers, tiles=tiles, tile_shapes=sorted(
        set(calls)), expected_tiles=want_tiles, one_tile_bit_equal=one_tile)
    if tiles != want_tiles or len(calls) != 2 * want_tiles:
        raise AssertionError(f"xl_upscale_serve: {len(calls)} tile decodes, "
                             f"expected 2 x {want_tiles}")
    if not one_tile:
        raise AssertionError("xl_upscale_serve: one tile is not the plain "
                             "decode bit for bit")
    return run


def lora_state(torch, unet, seed: int, peft: bool) -> dict:
    """A seeded rank-4 LoRA on ``attn1``/``attn2`` ``to_q``/``to_k``/
    ``to_v``/``to_out.0`` of every transformer block of ``unet``, in the
    diffusers attn-procs names or the peft names (the same tensors)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, w in unet.named_parameters():
        m = re.match(r"^(.+\.attn[12])\.(to_q|to_k|to_v|to_out)(\.0)?"
                     r"\.weight$", name)
        if not m:
            continue
        base, proj = m.group(1), m.group(2)
        out_f, in_f = w.shape
        down = torch.randn((LORA_RANK, in_f), generator=gen) / in_f ** 0.5
        up = torch.randn((out_f, LORA_RANK), generator=gen) * 0.05
        if peft:
            leaf = f"{base}.{proj}{'.0' if proj == 'to_out' else ''}"
            state[f"{leaf}.lora_A.weight"] = down
            state[f"{leaf}.lora_B.weight"] = up
        else:
            key = f"unet.{base}.processor.{proj}_lora"
            state[f"{key}.down.weight"] = down
            state[f"{key}.up.weight"] = up
    return state


def adapters_serve_phase(torch, registry, slot, solo_blob: str) -> dict:
    """LoRA and textual inversion on SD1.5 (random base, seed 0): a seeded
    rank-4 LoRA on every transformer's attention projections written once
    with diffusers attn-procs names and once with peft names, and a seeded
    two-vector inversion of ``<chip-smoke>``, under the run's settings
    root. Gates: both LoRA files merge to the same UNet bit for bit; scale 0
    renders serve's seed-1 image bit for bit; scales 1.0 and 0.5 are ledger
    entries of their own (their bytes printed) and their images differ; the
    inversion leaves a prompt without the token bit for bit serve's image
    and changes one with it; a two-image LoRA job solo and in a lane pinned
    at 2 rows bit for bit (the same composition); B1 = 10 x 20 a LoRA job,
    as a base job's. Every envelope stamped as JAX stamps it."""
    import numpy as np

    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    base = registry.pipeline("sd15")
    for name, peft in ((LORA_MODEL, False), (LORA_PEFT_MODEL, True)):
        model_dir(name).mkdir(parents=True, exist_ok=True)
        save_file(lora_state(torch, base.c.unet, seed=12, peft=peft),
                  model_dir(name) / "adapter.safetensors")
    hidden = base.c.text_encoders[0].config.hidden_size
    vectors = torch.randn((2, hidden), generator=torch.Generator()
                          .manual_seed(13)) * 0.5
    model_dir(TI_MODEL).mkdir(parents=True, exist_ok=True)
    save_file({TI_TOKEN: vectors},
              model_dir(TI_MODEL) / "learned_embeds.safetensors")

    t0 = time.perf_counter()
    merged = registry.pipeline("sd15", lora=LORA_MODEL, lora_scale=1.0)
    torch.cuda.synchronize()
    lora_load_s = time.perf_counter() - t0
    peft_pipe = registry.pipeline("sd15", lora=LORA_PEFT_MODEL)
    peft_params = dict(peft_pipe.c.unet.named_parameters())
    formats_equal = all(torch.equal(v, peft_params[k])
                        for k, v in merged.c.unet.named_parameters())
    moved = sum(not torch.equal(v, dict(base.c.unet.named_parameters())[k])
                for k, v in merged.c.unet.named_parameters())
    del peft_pipe, peft_params

    def serve(job_id, lanes=False, **over):
        job = dict(JOBS[0], id=job_id, **over)
        result = synchronous_do_work(job, slot, registry)
        n = job.get("num_images_per_prompt", 1)
        blob = check_envelope("adapters_serve", dict(job, width=n * 512),
                              result, lanes)
        return blob, result["pipeline_config"]

    entries = {}

    def note_entry(scale):
        """The ledger entry of (LORA_MODEL, scale), read once it is built."""
        entries[scale] = [e.bytes for k, e in
                          registry.residency._entries.items()
                          if k[:2] == ("pipeline", "sd15")
                          and k[3] == (LORA_MODEL, scale)][0]

    def stamps(cfg, want):
        if any(cfg.get(k) != v for k, v in want.items()):
            raise AssertionError(f"adapters_serve: stamps {cfg}")

    blobs = {}
    with env(CHIASWARM_STEPPER="0"):
        base_blob, base_cfg = serve("adapters-base")
        kernels.reset_launches()
        blobs["1.0"], cfg = serve("lora-1.0", lora=LORA_MODEL,
                                  cross_attention_scale=1.0)
        lora_launches = kernel_launches()
        lora_run = launched()
        check_b1("adapters_serve_lora", lora_launches,
                 SERVE_STEPS * B1_LAUNCHES_PER_UNET_EVAL)
        stamps(cfg, {"lora": LORA_MODEL, "cross_attention_scale": 1.0})
        lora_generation_s = cfg["generation_s"]
        note_entry(1.0)
        blobs["0.5"], cfg = serve("lora-0.5", lora=LORA_MODEL,
                                  cross_attention_scale=0.5)
        stamps(cfg, {"lora": LORA_MODEL, "cross_attention_scale": 0.5})
        note_entry(0.5)
        blobs["0.0"], _ = serve("lora-0.0", lora=LORA_MODEL,
                                cross_attention_scale=0.0)
        note_entry(0.0)
        blobs["ti_plain"], cfg = serve("ti-plain",
                                       textual_inversion=TI_MODEL)
        stamps(cfg, {"textual_inversion": TI_MODEL})
        blobs["ti_token"], _ = serve(
            "ti-token", textual_inversion=TI_MODEL,
            prompt=f"a lighthouse on a cliff in the style of {TI_TOKEN}")
        blobs["base_token"], _ = serve(
            "base-token",
            prompt=f"a lighthouse on a cliff in the style of {TI_TOKEN}")
    # a two-image LoRA job: solo (CFG batch 4) and a lane pinned at 2 rows
    grids = {}
    for mode in ("0", "1"):
        with env(CHIASWARM_STEPPER=mode, CHIASWARM_STEPPER_LANE_WIDTH="2"):
            blob, cfg = serve(f"lora-pair-{mode}", lanes=mode == "1",
                              lora=LORA_MODEL, num_images_per_prompt=2)
        stamps(cfg, {"lora": LORA_MODEL})
        grids[mode] = blob
    get_stepper(slot).shutdown()
    diff = np.abs(decode_png(blobs["1.0"]) - decode_png(base_blob))
    result = {
        "formats_merge_equal": formats_equal, "projections_moved": moved,
        "lora_load_s": lora_load_s, "ledger_bytes_by_scale": entries,
        "base_equals_serve": base_blob == solo_blob,
        "scale_0_equals_base": blobs["0.0"] == base_blob,
        "scales_differ": blobs["1.0"] != blobs["0.5"],
        "lora_vs_base": {"max": int(diff.max()),
                         "within_one": float((diff <= 1).mean())},
        "ti_without_token_equals_base": blobs["ti_plain"] == base_blob,
        "ti_token_changes_image": blobs["ti_token"] != blobs["base_token"],
        "lane_pair_equals_solo_pair": grids["1"] == grids["0"],
        "lora_generation_s": lora_generation_s,
        "base_generation_s": base_cfg["generation_s"],
        "launches": lora_launches, "b1_shapes": b1_shapes(lora_run)}
    emit("adapters_serve", **result)
    failed = [k for k in ("formats_merge_equal", "scale_0_equals_base",
                          "scales_differ", "ti_without_token_equals_base",
                          "ti_token_changes_image",
                          "lane_pair_equals_solo_pair") if not result[k]]
    if failed or set(entries) != {1.0, 0.5, 0.0} or moved == 0:
        raise AssertionError(f"adapters_serve failed {failed}; ledger "
                             f"entries by scale {entries}")
    return lora_run


# ---- the first non-diffusion workflows: stitch, img2txt, txt2audio --------

STITCH_SIZES = (512, 768, 1024, 256)
BLIP_MODEL = "Salesforce/blip-vqa-base"
BLIP_VOCAB = 30524      # BERT's 30,522 word pieces + [DEC] and [ENC]
BLIP_BAR = 2e-3         # card against CPU, float32 logits
BLIP_WORDS = ("a", "photo", "of", "what", "color", "is", "the", "sky",
              "cat", "dog", "on", "beach", "painting", "sunset", "lighthouse",
              "cliff", "at", "golden", "hour", "oil", "##s", "##ing")
CAPTION_CASES = (("caption", "", False), ("conditioned", "a photo of", False),
                 ("vqa", "what color is the sky?", True))
AUDIO_MODEL = "cvssp/audioldm-s-full-v2"
CLAP_VOCAB = 50265      # RoBERTa's byte-level vocab
AUDIO_BAR = 3e-2        # relative L2 of a bf16 UNet's waveform, B1 vs plain
AUDIO_STEPS = 20
AUDIO_JOBS = [{"id": f"audio-{seed}", "workflow": "txt2audio",
               "model_name": AUDIO_MODEL,
               "prompt": "rain on a tin roof, distant thunder",
               "negative_prompt": "low quality",
               "num_inference_steps": AUDIO_STEPS, "guidance_scale": guidance,
               "audio_length_in_s": seconds, "seed": seed,
               "content_type": "audio/wav"}
              for seed, seconds, guidance in ((1, 10.0, 2.5), (2, 5.0, 2.5),
                                              (3, 10.0, 1.0))]


def audioldm_b1_per_eval() -> int:
    """B1's launches in one eval of AudioLDM's UNet: its level-0 spatial
    self-attentions (2,560 tokens at 10 s, 1,280 at 5 s; the deeper levels
    stay under 1,024), ``layers_per_block`` down and one more up: 2 + 3."""
    from chiaswarm_tpu_torch.pipelines.audio import AUDIOLDM

    unet = AUDIOLDM.unet
    return unet.transformer_depth[0] * (2 * unet.layers_per_block + 1)


def stitch_serve_phase(torch, registry, pool) -> dict:
    """Four PNGs served by this script's hive (512, 768, 1024 and 256 px)
    as earlier jobs' ``resultUri`` through the worker as one ``stitch``
    job: a 288x288 JPEG, four ``image_map`` rects whose hrefs are the four
    URIs, the envelope's artifact byte for byte a CPU call of the port's
    ``stitch_callback`` on the same pictures; no kernel."""
    from PIL import Image

    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.workloads.stitch import stitch_callback

    pngs = {f"result-{i}.png": png_bytes(smooth_image(70 + i, size))
            for i, size in enumerate(STITCH_SIZES)}
    with LocalHive() as hive:
        hive.assets.update(pngs)
        job = {"id": "stitch-1", "workflow": "stitch", "model_name": "stitch",
               "seed": 1, "content_type": "image/jpeg",
               "jobs": [{"resultUri": f"{hive.uri}/assets/{name}",
                         "model_name": "sd15", "fileName": name}
                        for name in pngs]}
        kernels.reset_launches()
        worker = serve_through_worker(hive, pool, registry, [job])
        run, launches = launched(), kernel_launches()
        [result] = hive.results
        rows = trace_rows(worker)
    cfg = result["pipeline_config"]
    if "error" in cfg:
        raise AssertionError(f"stitch_serve failed: {cfg['error']}")
    images = [Image.open(io.BytesIO(b)).convert("RGB") for b in pngs.values()]
    want, want_cfg = stitch_callback(None, "stitch", seed=1, jobs=job["jobs"],
                                     images=images)
    artifact = result["artifacts"]["primary"]
    size = Image.open(io.BytesIO(base64.b64decode(artifact["blob"]))).size
    hrefs = [m["href"] for m in cfg["image_map"]]
    emit("stitch_serve", job_seconds=rows[job["id"]]["seconds"],
         jpeg_size=list(size), image_map=cfg["image_map"],
         bytes=len(base64.b64decode(artifact["blob"])), launches=launches)
    if artifact["content_type"] != "image/jpeg" or size != (288, 288):
        raise AssertionError(f"stitch_serve: {artifact['content_type']} "
                             f"{size}, not a 288x288 JPEG")
    if hrefs != [j["resultUri"] for j in job["jobs"]]:
        raise AssertionError(f"stitch_serve: hrefs {hrefs}")
    if result["artifacts"] != want or cfg["image_map"] != want_cfg["image_map"]:
        raise AssertionError("stitch_serve: the worker's collage differs from "
                             "a CPU call of stitch_callback")
    if sum(launches.values()):
        raise AssertionError(f"stitch_serve launched {launches}")
    return run


def synthetic_wordpiece_vocab() -> list[str]:
    """BLIP's vocab shape: BERT's specials at their ids ([PAD] 0, [UNK] 100,
    [CLS] 101, [SEP] 102, [MASK] 103), a few words, word pieces and
    continuation pieces made up to 30,522 lines, then [DEC] and [ENC]."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    lines += ["[UNK]", "[CLS]", "[SEP]", "[MASK]", *BLIP_WORDS]
    i = 0
    while len(lines) < BLIP_VOCAB - 2:
        lines.append(f"w{i}" if i % 3 else f"##w{i}")
        i += 1
    return lines + ["[DEC]", "[ENC]"]


def write_blip(torch, path: Path) -> dict:
    """BLIP-base with its question tower (``BLIP_BASE``: ViT-B/16 at 384 px,
    12 x 768 BERT towers), random from seed 0 on the card, written as a
    transformers ``BlipForQuestionAnswering`` directory (``model.safetensors``
    in float32, ``vocab.txt``); returns its tensors on the host."""
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.models.tokenizer import WordPieceTokenizer
    from chiaswarm_tpu_torch.pipelines.caption import (
        CaptionComponents,
        transformers_state,
    )

    t0 = time.perf_counter()
    lines = synthetic_wordpiece_vocab()
    source = CaptionComponents.random(
        "blip_base", seed=0, vqa=True, device="cuda", model_name=BLIP_MODEL,
        tokenizer=WordPieceTokenizer({t: i for i, t in enumerate(lines)}))
    state = {k: v.detach().cpu().contiguous()
             for k, v in transformers_state(source).items()}
    path.mkdir(parents=True, exist_ok=True)
    save_file(state, path / "model.safetensors", {"format": "pt"})
    (path / "vocab.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    del source
    torch.cuda.empty_cache()
    return {"state": state, "write_s": time.perf_counter() - t0,
            "bytes": (path / "model.safetensors").stat().st_size}


@contextlib.contextmanager
def record_logits(owner, attr: str):
    """Each call of ``owner``'s LM-head method ``attr`` in the block, its
    output on the host, in order (the prefill's logits, then one per
    decode step)."""
    calls = []
    head = getattr(owner, attr)

    def kept(x):
        out = head(x)
        calls.append(out.float().cpu())
        return out

    setattr(owner, attr, kept)
    try:
        yield calls
    finally:
        delattr(owner, attr)


def step_logits(calls: list, prompt_len: int) -> list:
    """Per decode step, the logits that chose its token: the prefill's at
    its last real position, then each step's."""
    return [calls[0][0, prompt_len - 1]] + [c[0, 0] for c in calls[1:]]


def logit_gate(name: str, bar: float, card: list, cpu: list,
               stop: int) -> dict:
    """The first step's logits within ``bar`` of the CPU's; the chosen ids
    equal up to the first step whose top-two CPU logit gap is below the bar
    (or the ``stop`` id). Returns the step that ended the comparison."""
    first_err = float((card[0] - cpu[0]).abs().max())
    close_at = None
    for t, (a, b) in enumerate(zip(card, cpu)):
        top2 = b.topk(2).values
        if float(top2[0] - top2[1]) < bar:
            close_at = t
            break
        if int(a.argmax()) != int(b.argmax()):
            raise AssertionError(f"{name}: step {t} chose "
                                 f"{int(a.argmax())} on the card, "
                                 f"{int(b.argmax())} on the CPU")
        if int(b.argmax()) == stop:
            break
    if not first_err <= bar:
        raise AssertionError(f"{name}: first-step logits differ by "
                             f"{first_err} (bar {bar})")
    return {"first_step_max_abs_err": first_err, "close_step": close_at,
            "steps_compared": t + 1}


def caption_serve_phase(torch, strict, pool) -> dict:
    """BLIP-base at its published widths with its question tower (random
    from seed 0, written as a transformers directory with a synthetic
    30,524-entry vocab, loaded by a registry with no random fallback, every
    tensor equal to its source), one caption, one conditioned caption and
    one VQA job through the worker on one picture from this script's hive:
    each text equal to a direct call's on the card; the first decode step's
    logits within 2e-3 of a CPU load of the same directory, the chosen ids
    equal to the CPU's up to the first step whose top-two gap is below that
    bar (printed); no kernel (577 vision tokens and 41 text tokens stay on
    the plain path). Prints each job's seconds and the vision encode's
    device ms."""
    import numpy as np

    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.caption import (
        CaptionComponents,
        CaptionPipeline,
        transformers_state,
    )

    written = write_blip(torch, model_dir(BLIP_MODEL))
    t0 = time.perf_counter()
    pipe = strict.caption_pipeline(BLIP_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    unequal = [k for k, v in transformers_state(pipe.c).items()
               if not torch.equal(v.detach().cpu(), written["state"][k])]
    if unequal or pipe.c.encoder is None:
        raise AssertionError(f"caption_serve: loaded tensors differ "
                             f"{unequal[:4]} (question tower: "
                             f"{pipe.c.encoder is not None})")
    picture = smooth_image(81, 512)
    jobs = [{"id": f"caption-{case}", "workflow": "img2txt",
             "model_name": BLIP_MODEL, "seed": 1, "prompt": prompt,
             "start_image_uri": "/assets/picture.png",
             "content_type": "application/json",
             **({"parameters": {"model_type": "BlipForQuestionAnswering"}}
                if vqa else {})} for case, prompt, vqa in CAPTION_CASES]
    with LocalHive() as hive:
        hive.assets["picture.png"] = png_bytes(picture)
        kernels.reset_launches()
        worker = serve_through_worker(hive, pool, strict,
                                      on_hive(hive, jobs))
        run, launches = launched(), kernel_launches()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
    cpu = CaptionPipeline(CaptionComponents.from_checkpoint(
        model_dir(BLIP_MODEL), BLIP_MODEL, device="cpu"))
    sep = pipe.c.config.text.sep_token_id
    cases = {}
    for (case, prompt, vqa), job in zip(CAPTION_CASES, jobs):
        cfg = by_id[job["id"]]["pipeline_config"]
        if "error" in cfg:
            raise AssertionError(f"caption_serve {case}: {cfg['error']}")
        with record_logits(pipe.c.decoder, "lm_logits") as card_calls:
            text = pipe(picture, prompt, vqa=vqa)
        with record_logits(cpu.c.decoder, "lm_logits") as cpu_calls:
            cpu_text = cpu(picture, prompt, vqa=vqa)
        plen = 1 if (vqa or not prompt) else len(
            pipe.c.tokenizer.tokenize(prompt)[:16]) + 1
        gate = logit_gate(f"caption_serve {case}", BLIP_BAR,
                          step_logits(card_calls, plen),
                          step_logits(cpu_calls, plen), sep)
        if cfg["caption"] != text:
            raise AssertionError(f"caption_serve {case}: the worker's text "
                                 f"{cfg['caption']!r} != a direct call's "
                                 f"{text!r}")
        cases[case] = {"job_seconds": rows[job["id"]]["seconds"],
                       "elapsed_s": cfg["elapsed_s"], "words": len(text.split()),
                       "cpu_text_equal": text == cpu_text, **gate}
    pixels = pipe.preprocess(picture)
    encode_ms = time_ms(torch, lambda: pipe.c.vision(pixels))
    emit("caption_serve", load_s=load_s, write_s=written["write_s"],
         checkpoint_bytes=written["bytes"], param_bytes=pipe.c.param_bytes(),
         cases=cases, vision_encode_ms=encode_ms,
         vision_tokens=pipe.c.config.vision.num_tokens, launches=launches)
    if sum(launches.values()):
        raise AssertionError(f"caption_serve launched {launches}")
    del cpu
    return run


def synthetic_byte_level_vocab() -> tuple[dict, list]:
    """CLAP's tokenizer shape: RoBERTa's specials, the 256 byte symbols,
    merges that build a few words with and without their leading ``Ġ``,
    padded to 50,265 entries."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    merges = []
    for word in ("rain", "on", "a", "tin", "roof", "distant", "thunder",
                 "low", "quality", "dog", "bark", "ing"):
        for piece in (word, "Ġ" + word):
            cur = piece[0]
            for ch in piece[1:]:
                if (cur, ch) not in merges:
                    merges.append((cur, ch))
                cur += ch
                vocab.setdefault(cur, len(vocab))
    i = 0
    while len(vocab) < CLAP_VOCAB:
        vocab[f"Ġfiller{i}"] = len(vocab)
        i += 1
    return vocab, merges


def write_audioldm(torch, path: Path) -> dict:
    """AudioLDM at JAX's widths (``AUDIOLDM``: CLAP 12 x 768, the UNet
    (128, 256, 384, 640) and the VAE in bf16, CLAP and the vocoder in
    float32), random from seed 0 on the card, written as a diffusers
    directory at those dtypes (``text_encoder/``, ``unet/``, ``vae/``,
    ``vocoder/``, ``tokenizer/`` with a synthetic byte-level vocab);
    returns its tensors on the host."""
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.pipelines.audio import AudioComponents

    t0 = time.perf_counter()
    source = AudioComponents.random("audioldm", seed=0, device="cuda",
                                    model_name=AUDIO_MODEL)
    states, total = {}, 0
    for name in ("text_encoder", "unet", "vae", "vocoder"):
        state = {k: v.detach().cpu().contiguous()
                 for k, v in getattr(source, name).state_dict().items()}
        (path / name).mkdir(parents=True, exist_ok=True)
        file = path / name / ("model.safetensors" if name == "text_encoder"
                              else "diffusion_pytorch_model.safetensors")
        save_file(state, file, {"format": "pt"})
        states[name] = state
        total += file.stat().st_size
    vocab, merges = synthetic_byte_level_vocab()
    (path / "tokenizer").mkdir(parents=True, exist_ok=True)
    (path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab),
                                                    encoding="utf-8")
    (path / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    del source
    torch.cuda.empty_cache()
    return {"states": states, "write_s": time.perf_counter() - t0,
            "bytes": total}


def audio_samples(artifact: dict, rate: int = 16000) -> "np.ndarray":
    """An audio artifact's 16-bit samples: WAV through ``wave``, MP3
    through the ffmpeg CLI (decoded at ``rate``)."""
    import shutil
    import wave

    import numpy as np

    blob = base64.b64decode(artifact["blob"])
    if artifact["content_type"] == "audio/wav":
        with wave.open(io.BytesIO(blob)) as fh:
            return np.frombuffer(fh.readframes(fh.getnframes()), "<i2")
    proc = subprocess.run(
        [shutil.which("ffmpeg"), "-hide_banner", "-loglevel", "error",
         "-i", "pipe:0", "-f", "s16le", "-ac", "1", "-ar", str(rate),
         "pipe:1"],
        input=blob, capture_output=True, timeout=120, check=True)
    return np.frombuffer(proc.stdout, "<i2")


AUDIO_STAGES = {"text": "encode_text", "denoise": "denoise",
                "vae_decode": "decode_mel", "vocoder": "vocode"}


@contextlib.contextmanager
def timed_stages(torch, pipe, stages: dict):
    """CUDA-event ms (``ms``: summed per stage; ``ms_each``: per call) and
    host seconds (``host_s_each``) of each stage (``stage: method of pipe``)
    of ``pipe``'s calls in the block, and each stage's last first argument
    and output (``args``, ``out``)."""
    rec = {"events": collections.defaultdict(list),
           "host_s_each": collections.defaultdict(list), "args": {},
           "out": {}}

    def timed(stage, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kw)
            end.record()
            rec["host_s_each"][stage].append(time.perf_counter() - t0)
            rec["events"][stage].append((start, end))
            rec["args"][stage] = args[0] if args else None
            rec["out"][stage] = out
            return out
        return call

    for stage, attr in stages.items():
        setattr(pipe, attr, timed(stage, getattr(pipe, attr)))
    try:
        yield rec
    finally:
        for attr in stages.values():
            delattr(pipe, attr)
        torch.cuda.synchronize()
        rec["ms_each"] = {stage: [s.elapsed_time(e) for s, e in evs]
                          for stage, evs in rec["events"].items()}
        rec["ms"] = {stage: sum(ms) for stage, ms in rec["ms_each"].items()}


def audio_serve_phase(torch, strict, pool, b1_rows: list) -> dict:
    """AudioLDM at JAX's widths (``write_audioldm``) loaded by a registry
    with no random fallback (every tensor equal to its source, UNet and VAE
    bf16, CLAP and vocoder float32), three 20-step jobs through the worker:
    10 s at guidance 2.5, 5 s at 2.5, 10 s at 1.0. B1 exactly 5 x UNet
    evals at each job's shape (100 at (2, 2560, 2560, 4, 32), 100 at (2,
    1280, 1280, 4, 32), 100 at (1, 2560, 2560, 4, 32), bf16) and no other
    kernel; ``audio/wav`` (``audio/mpeg`` where ffmpeg is on PATH); 160,000
    and 80,000 samples; the first job again, the same bytes; its waveform
    from a direct call within 3e-2 relative L2 of the same call with the
    UNet's attention on the plain route, and the worker's WAV the direct
    call's samples; the vocoder on the card (cuDNN's default TF32) against
    its float32 CPU run on the same mel, within that bar. Prints each job's
    seconds and ``generation_s``, the device ms of each stage (text,
    denoise, VAE decode, vocoder), B1's share and the peak memory."""
    import copy
    import shutil

    import numpy as np

    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl
    from chiaswarm_tpu_torch.workloads.audio import pcm16_wav

    written = write_audioldm(torch, model_dir(AUDIO_MODEL))
    t0 = time.perf_counter()
    pipe = strict.audio_pipeline(AUDIO_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    unequal = [f"{m}.{k}" for m, state in written["states"].items()
               for k, v in getattr(pipe.c, m).state_dict().items()
               if not torch.equal(v.detach().cpu(), state[k])]
    dtypes = {m: str(next(getattr(pipe.c, m).parameters()).dtype)
              for m in written["states"]}
    if unequal:
        raise AssertionError(f"audio_serve: loaded tensors differ: "
                             f"{unequal[:4]}")
    if type(pipe.c.tokenizer).__name__ != "ByteLevelBpeTokenizer":
        raise AssertionError(f"audio_serve: tokenizer {pipe.c.tokenizer}")

    ffmpeg = shutil.which("ffmpeg")
    want_type = "audio/mpeg" if ffmpeg else "audio/wav"
    per_eval = audioldm_b1_per_eval()
    with LocalHive() as hive:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        worker = serve_through_worker(hive, pool, strict, AUDIO_JOBS)
        run, launches = launched(), kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
        again_job = dict(AUDIO_JOBS[0], id="audio-1-again")
        serve_through_worker(hive, pool, strict, [again_job])
        again = hive.results[-1]
    want_shapes = collections.Counter()
    jobs = {}
    for job in AUDIO_JOBS:
        result = by_id[job["id"]]
        cfg = result["pipeline_config"]
        if "error" in cfg:
            raise AssertionError(f"audio_serve {job['id']}: {cfg['error']}")
        artifact = result["artifacts"]["primary"]
        samples = audio_samples(artifact)
        want_n = int(job["audio_length_in_s"] * 16000)
        exact = artifact["content_type"] == "audio/wav"
        if artifact["content_type"] != want_type or (
                len(samples) != want_n if exact
                else abs(len(samples) - want_n) > 2 * 1152):
            raise AssertionError(f"audio_serve {job['id']}: "
                                 f"{artifact['content_type']} of "
                                 f"{len(samples)} samples, want {want_type} "
                                 f"of {want_n}")
        rows_b1 = 2 if job["guidance_scale"] > 1.0 else 1
        lt, lm = pipe._latent_shape(pipe._frames_for(
            job["audio_length_in_s"]))[1:]
        tokens = lt * lm
        want_shapes[(rows_b1, tokens, tokens, 4, 32, "bfloat16")] += \
            per_eval * AUDIO_STEPS
        jobs[job["id"]] = {"job_seconds": rows[job["id"]]["seconds"],
                           "generation_s": cfg["generation_s"],
                           "samples": len(samples),
                           "duration_s": cfg["duration_s"]}
    got_shapes = collections.Counter(run["flash_attention"]["shapes"])
    if got_shapes != want_shapes or sum(launches.values()) != \
            launches["flash_attention"]:
        raise AssertionError(f"audio_serve launched {launches} by shape "
                             f"{dict(got_shapes)}, want {dict(want_shapes)}")
    repeat_equal = (again["artifacts"]["primary"]
                    == by_id[AUDIO_JOBS[0]["id"]]["artifacts"]["primary"])
    if not repeat_equal:
        raise AssertionError("audio_serve: the same job twice differs")

    # the 10 s job by a direct call, its stages timed; the plain route
    job = AUDIO_JOBS[0]
    kw = dict(prompt=job["prompt"], negative_prompt=job["negative_prompt"],
              steps=AUDIO_STEPS, guidance_scale=job["guidance_scale"],
              duration_s=job["audio_length_in_s"], seed=job["seed"])
    kernels.reset_launches()
    with timed_stages(torch, pipe, AUDIO_STAGES) as stages:
        t1 = time.perf_counter()
        wav, _, _ = pipe(**kw)
        direct_s = time.perf_counter() - t1
    direct_run = launched()
    set_attn_impl(pipe.c.unet, "xla")
    try:
        plain, _, _ = pipe(**kw)
    finally:
        set_attn_impl(pipe.c.unet, "auto")
    rel = float(np.linalg.norm(wav - plain) / np.linalg.norm(plain))
    worker_samples = audio_samples(by_id[job["id"]]["artifacts"]["primary"])
    wav_equal = (want_type != "audio/wav" or np.array_equal(
        worker_samples, np.frombuffer(pcm16_wav(wav[0])[44:], "<i2")))
    # the vocoder's float32 convs on the card (cuDNN, TF32 by default)
    # against its CPU run on the same mel
    mel = stages["out"]["vae_decode"]
    with torch.inference_mode():
        card_wav = pipe.c.vocoder(mel).cpu()
        cpu_voc = copy.deepcopy(pipe.c.vocoder).cpu()
        cpu_wav = cpu_voc(mel.cpu())
    del cpu_voc
    voc_rel = float((card_wav - cpu_wav).norm() / cpu_wav.norm())
    voc_err = float((card_wav - cpu_wav).abs().max())
    share = b1_share(b1_rows, direct_run, stages["ms"]["denoise"])
    total_ms = sum(stages["ms"].values())
    emit("audio_serve", load_s=load_s, write_s=written["write_s"],
         checkpoint_bytes=written["bytes"], param_bytes=pipe.c.param_bytes(),
         dtypes=dtypes, ffmpeg=ffmpeg, content_type=want_type, jobs=jobs,
         direct_10s={"seconds": direct_s, "stage_ms": stages["ms"],
                     "device_ms": total_ms, **share,
                     "b1_share_of_device": share["b1_ms"] / total_ms},
         b1_vs_plain_rel_l2=rel, tolerance=AUDIO_BAR,
         worker_wav_equals_direct=wav_equal, repeat_bytes_equal=repeat_equal,
         vocoder_card_vs_cpu={"rel_l2": voc_rel, "max_abs_err": voc_err,
                              "cudnn_allow_tf32":
                                  torch.backends.cudnn.allow_tf32},
         max_memory_allocated=peak, launches=launches,
         b1_shapes=b1_shapes(run))
    if not rel <= AUDIO_BAR:
        raise AssertionError(f"audio_serve: B1 against the plain route: "
                             f"relative L2 {rel} (bar {AUDIO_BAR})")
    if not wav_equal:
        raise AssertionError("audio_serve: the worker's WAV differs from a "
                             "direct call's samples")
    if not voc_rel <= AUDIO_BAR:
        raise AssertionError(f"audio_serve: the vocoder on the card differs "
                             f"from its CPU run by {voc_rel} relative L2")
    return run


TTS_MODEL = "suno/bark"  # random weights from seed 0 (the registry's fallback)
TTS_TEXT = "Hello, my name is Suno. And, uh, I like pizza."
TTS_SECONDS = 4.0
TTS_SEM_STEPS = 32      # semantic steps held against the float32 CPU run
TTS_LOGIT_BAR = 0.08    # bf16 card against float32 CPU, first-step logits
TTS_CODEC_BAR = 1e-2    # relative L2 of the codec's waveform, card vs CPU
TTS_STAGES = {"semantic": "_semantic", "coarse": "_coarse", "fine": "_fine",
              "codec": "decode_codes"}


def tts_preset(seed: int) -> dict:
    """A voice preset of Bark's shapes (a bundled speaker's: ~6 s of
    history), random from ``seed``, as JSON lists."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"semantic_prompt": rng.integers(0, 10_000, 300).tolist(),
            "coarse_prompt": rng.integers(0, 1024, (2, 450)).tolist(),
            "fine_prompt": rng.integers(0, 1024, (8, 450)).tolist()}


TTS_JOBS = [{"id": "tts-1", "workflow": "txt2audio", "model_name": TTS_MODEL,
             "prompt": TTS_TEXT, "audio_length_in_s": TTS_SECONDS, "seed": 1,
             "content_type": "audio/wav"}]
TTS_JOBS += [dict(TTS_JOBS[0], id="tts-preset", seed=2,
                  parameters={"history": tts_preset(2)}),
             dict(TTS_JOBS[0], id="tts-named", seed=3,
                  parameters={"voice_preset": "v2/en_speaker_6"})]


def profile_tool():
    """``tools/torch_serve_profile.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_serve_profile", ROOT / "tools" / "torch_serve_profile.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tts_semantic_gate(torch, pipe) -> dict:
    """The semantic stage at ``top_k = 1`` for ``TTS_SEM_STEPS`` steps on
    the card (bf16), and one float32 CPU forward of the same weights over
    the card's prefill and the ids it fed back (teacher forcing, so a close
    pick does not carry into later steps): ``logit_gate`` at
    ``TTS_LOGIT_BAR`` over the stage's allowed ids (the first step's logits
    within the bar, the ids equal up to the first close step), then every
    later step's id the CPU's wherever the CPU's top-two gap is at least
    the bar. Prints each step's error."""
    import copy

    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.models.gpt import init_caches

    fam = pipe.c.family
    allowed, eos = fam.semantic_vocab + 1, fam.semantic_vocab
    L = fam.max_input_semantic_length
    with record_logits(pipe.c.semantic.lm_head, "forward") as calls:
        pipe._semantic(TTS_TEXT, pipe.generator(1), 0.0, 1, TTS_SEM_STEPS,
                       None)
    card = [c[:allowed] for c in step_logits(calls, L + 1)]
    fed, done = [], False
    for c in card:  # the ids the decode embedded: the picks, then the pad
        fed.append(eos if done else int(c.argmax()))
        done = done or fed[-1] == eos
    sem = cast_module(copy.deepcopy(pipe.c.semantic).cpu(), torch.float32)
    with torch.inference_mode():
        prefill = pipe.semantic_embeds(TTS_TEXT, None).cpu().float()
        seq = torch.cat([prefill, sem.input_embeds_layer(
            torch.tensor([fed[:-1]]))], dim=1)
        n = seq.shape[1]
        logits, _ = sem(None, init_caches(sem.config, 1, "cpu", torch.float32,
                                          length=n), 0, n, embeds=seq)
    del sem
    cpu = [logits[0, L + t, :allowed] for t in range(len(card))]
    gate = logit_gate("tts_serve semantic", TTS_LOGIT_BAR, card, cpu, eos)
    errs = [float((a - b).abs().max()) for a, b in zip(card, cpu)]
    compared = 0
    for t, (a, b) in enumerate(zip(card, cpu)):
        top2 = b.topk(2).values
        if float(top2[0] - top2[1]) < TTS_LOGIT_BAR:
            continue
        compared += 1
        if int(a.argmax()) != int(b.argmax()):
            raise AssertionError(f"tts_serve semantic: step {t} chose "
                                 f"{int(a.argmax())} on the card, "
                                 f"{int(b.argmax())} on the CPU (forced)")
    return {**gate, "bar": TTS_LOGIT_BAR, "steps": len(card),
            "forced_steps_compared": compared,
            "step_max_abs_err": max(errs),
            "step_mean_max_abs_err": sum(errs) / len(errs),
            "first_step_rel_l2": float((card[0] - cpu[0]).norm()
                                       / cpu[0].norm()),
            "first_step_logit_range": [float(cpu[0].min()),
                                       float(cpu[0].max())]}


def tts_serve_phase(torch, registry, pool) -> dict:
    """Bark at its published widths (three 24 x 1,024 GPTs in bf16 with
    vocabularies 129,600 / 12,096 / 1,056 and the 8-codebook EnCodec at
    24 kHz in float32), random from seed 0 through the registry's
    ``allow_random`` fallback; through the worker a 4 s job at the default
    temperature 0.7, a job with a ``history`` preset of Bark's shapes and a
    job naming a preset by a string, then the first job again. Gates: the
    served envelopes error-free with ``audio/wav`` (``audio/mpeg`` with
    ffmpeg) of ``frames x 320`` samples at 24,000 Hz; the repeat the same
    bytes; the named preset JAX's fatal envelope; no port kernel launched;
    the semantic stage at ``top_k = 1`` against a float32 CPU run of the
    same weights (``tts_semantic_gate``); the codec's waveform on the card
    within 1e-2 relative L2 of its float32 CPU run on the same codes.
    Prints job seconds and ``generation_s``, the served jobs' device ms and
    host seconds by stage, decode tokens/s, the busy share and launches per
    decode step from the profile tool, and the peak memory."""
    import copy
    import dataclasses
    import shutil

    import numpy as np

    from chiaswarm_tpu_torch.pipelines.tts import TTSPipeline

    t0 = time.perf_counter()
    pipe = registry.tts_pipeline(TTS_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fam = pipe.c.family
    hop, rate = fam.codec.hop_length, fam.codec.sampling_rate
    params = {m.__class__.__name__ + ":" + name: sum(
        p.numel() for p in m.parameters())
        for name, m in zip(("semantic", "coarse", "fine", "codec"),
                           pipe.c.modules())}
    if fam.name != "bark" or (hop, rate) != (320, 24000):
        raise AssertionError(f"tts_serve: family {fam.name}, hop {hop}, "
                             f"rate {rate}")
    ffmpeg = shutil.which("ffmpeg")
    want_type = "audio/mpeg" if ffmpeg else "audio/wav"
    tool = profile_tool()
    with LocalHive() as hive:
        from chiaswarm_tpu_torch.ops import kernels

        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with tool.counted_decode_steps(pipe) as calls, \
                timed_stages(torch, pipe, TTS_STAGES) as stages:
            worker = serve_through_worker(hive, pool, registry, TTS_JOBS)
        peak = torch.cuda.max_memory_allocated()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
        serve_through_worker(hive, pool, registry,
                             [dict(TTS_JOBS[0], id="tts-1-again")])
        again = hive.results[-1]
        run, launches = launched(), kernel_launches()
    jobs = {}
    for job in TTS_JOBS[:2]:
        result = by_id[job["id"]]
        cfg = result["pipeline_config"]
        if "error" in cfg:
            raise AssertionError(f"tts_serve {job['id']}: {cfg['error']}")
        artifact = result["artifacts"]["primary"]
        samples = audio_samples(artifact, rate)
        want_n = cfg["frames"] * hop
        exact = artifact["content_type"] == "audio/wav"
        if (artifact["content_type"] != want_type or cfg["sample_rate"] != rate
                or (len(samples) != want_n if exact
                    else abs(len(samples) - want_n) > 2 * 1152)):
            raise AssertionError(f"tts_serve {job['id']}: "
                                 f"{artifact['content_type']} of "
                                 f"{len(samples)} samples at "
                                 f"{cfg['sample_rate']} Hz, want {want_type} "
                                 f"of {want_n} at {rate}")
        jobs[job["id"]] = {"job_seconds": rows[job["id"]]["seconds"],
                           "generation_s": cfg["generation_s"],
                           "semantic_tokens": cfg["semantic_tokens"],
                           "frames": cfg["frames"], "samples": len(samples),
                           "duration_s": cfg["duration_s"]}
    named = by_id["tts-named"]
    named_error = named["pipeline_config"].get("error", "")
    if named.get("fatal_error") is not True \
            or "named voice preset" not in named_error:
        raise AssertionError(f"tts_serve: the named preset's envelope: "
                             f"{named.get('fatal_error')} {named_error!r}")
    repeat_equal = (again["artifacts"]["primary"]
                    == by_id["tts-1"]["artifacts"]["primary"])
    if not repeat_equal:
        raise AssertionError("tts_serve: the same job twice differs")
    if any(launches.values()):
        raise AssertionError(f"tts_serve launched kernels: {launches}")

    # the served jobs' stages, in the order the worker ran them
    steps = []
    for stage, n in calls:
        if stage == "semantic":
            steps.append({"semantic": 0, "coarse": 0})
        steps[-1][stage] += n
    host = stages["host_s_each"]
    served = {"stage_ms": stages["ms_each"], "stage_host_s": dict(host),
              "device_ms": [sum(ms) for ms in zip(*stages["ms_each"].values())],
              "decode_steps": steps,
              "semantic_tokens_per_s": [
                  d["semantic"] / s for d, s in zip(steps, host["semantic"])],
              "coarse_tokens_per_s": [
                  d["coarse"] / s for d, s in zip(steps, host["coarse"])]}
    # the codec on the card (cuDNN's default TF32) against its float32 CPU
    # run on the same codes
    codes = stages["args"]["codec"]
    cpu_codec = TTSPipeline(dataclasses.replace(
        pipe.c, codec=copy.deepcopy(pipe.c.codec).cpu(),
        device=torch.device("cpu")))
    card_wav = pipe.decode_codes(codes)
    cpu_wav = cpu_codec.decode_codes(codes)
    del cpu_codec
    codec_rel = float(np.linalg.norm(card_wav - cpu_wav)
                      / np.linalg.norm(cpu_wav))
    semantic_gate = tts_semantic_gate(torch, pipe)
    profile = tool.tts_profile(torch, pipe, TTS_SECONDS, warm_up=False)
    profile["top"] = profile["top"][:8]
    emit("tts_serve", load_s=load_s, param_bytes=pipe.c.param_bytes(),
         params=params, dtypes={name: str(next(m.parameters()).dtype)
                                for name, m in zip(
                                    ("semantic", "coarse", "fine", "codec"),
                                    pipe.c.modules())},
         ffmpeg=ffmpeg, content_type=want_type, jobs=jobs,
         repeat_bytes_equal=repeat_equal, named_preset_error=named_error,
         launches=launches, served=served, profile=profile,
         semantic_vs_cpu=semantic_gate,
         codec_vs_cpu={"rel_l2": codec_rel,
                       "max_abs_err": float(np.abs(card_wav - cpu_wav).max()),
                       "frames": int(codes.shape[1]), "bar": TTS_CODEC_BAR,
                       "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32},
         max_memory_allocated=peak, nvidia_smi=nvidia_smi_line())
    if not codec_rel <= TTS_CODEC_BAR:
        raise AssertionError(f"tts_serve: the codec on the card differs from "
                             f"its CPU run by {codec_rel} relative L2")
    return run


VIDEO_TXT_MODEL = "damo-vilab/text-to-video-ms-1.7b"  # random, seed 0
VIDEO_IMG_MODEL = "stabilityai/stable-video-diffusion-img2vid"  # random
VIDEO_PROMPT = "a red fox running through fresh snow at dawn, cinematic"
TXT2VID_JOBS = [
    {"id": "txt2vid-1", "workflow": "txt2vid", "model_name": VIDEO_TXT_MODEL,
     "prompt": VIDEO_PROMPT, "seed": 1, "content_type": "video/mp4"},
    {"id": "txt2vid-1-again", "workflow": "txt2vid",
     "model_name": VIDEO_TXT_MODEL, "prompt": VIDEO_PROMPT, "seed": 1,
     "content_type": "video/mp4"},
    {"id": "txt2vid-nocfg", "workflow": "txt2vid",
     "model_name": VIDEO_TXT_MODEL, "prompt": VIDEO_PROMPT, "seed": 2,
     "guidance_scale": 1.0, "content_type": "video/mp4"},
]
IMG2VID_STEPS = 25
IMG2VID_JOBS = [
    {"id": "img2vid-1", "workflow": "img2vid", "model_name": VIDEO_IMG_MODEL,
     "start_image_uri": "/assets/svd-a.png", "seed": 1,
     "num_inference_steps": IMG2VID_STEPS, "content_type": "video/mp4"},
    {"id": "img2vid-1-again", "workflow": "img2vid",
     "model_name": VIDEO_IMG_MODEL, "start_image_uri": "/assets/svd-a.png",
     "seed": 1, "num_inference_steps": IMG2VID_STEPS,
     "content_type": "video/mp4"},
    {"id": "img2vid-b", "workflow": "img2vid", "model_name": VIDEO_IMG_MODEL,
     "start_image_uri": "/assets/svd-b.png", "seed": 1,
     "num_inference_steps": IMG2VID_STEPS, "content_type": "video/mp4"},
]
VID2VID_FRAMES = 12
VID2VID_HW = (512, 910)  # a 16:9 clip at 512 px height, even width
VID2VID_STEPS = 20
VID2VID_STRENGTH = 0.6
VID2VID_JOBS = [
    {"id": f"vid2vid-{tag}", "workflow": "vid2vid", "model_name": "sd15",
     "video_uri": "/assets/clip.mp4", "prompt": "a watercolor painting",
     "negative_prompt": "blurry", "seed": 1,
     "num_inference_steps": VID2VID_STEPS, "strength": VID2VID_STRENGTH,
     "content_type": "video/mp4"} for tag in ("1", "1-again")]
# relative L2 of one bf16 UNet eval through B1 against the plain route (as
# the SD phases' bar), and of a bf16 eval on the card at 2 frames against
# a float32 CPU eval of the same weights
VIDEO_PLAIN_BAR = 3e-2
VIDEO_CPU_BAR = 5e-2
#: B1 launches an eval at each of its shapes: a level's spatial attentions
#: (2 down, 3 up); level 0 at ModelScope's 256 px, levels 0 and 1 at SVD's
#: 512 px and SD1.5's 512x960
VIDEO_B1_PER_EVAL = 5
#: the config keys of JAX's callbacks (chiaswarm_tpu/workloads/video.py),
#: on a node without a safety checker, with the ``seed`` its slot adds
VIDEO_CONFIG_KEYS = {
    "txt2vid": {"model_name", "family", "mode", "frames", "steps",
                "guidance_scale", "size", "compiled_size", "scheduler",
                "nsfw", "safety_checker", "fps", "generation_s",
                "frames_per_sec", "slot", "seed"},
    "img2vid": {"model_name", "family", "mode", "frames", "steps", "fps",
                "motion_bucket_id", "noise_aug_strength", "guidance_scale",
                "size", "compiled_size", "scheduler", "nsfw",
                "safety_checker", "generation_s", "frames_per_sec", "slot",
                "seed"},
    "vid2vid": {"nsfw", "safety_checker", "model_name", "frames", "fps",
                "compute_cost", "seed"},
}


def clip_frames(blob_b64: str):
    """The frames of a base64 mp4 as uint8 RGB (F, H, W, 3), read back
    with OpenCV."""
    import tempfile

    import cv2
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "clip.mp4"
        path.write_bytes(base64.b64decode(blob_b64))
        cap = cv2.VideoCapture(str(path))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)


def check_video_envelope(phase: str, kind: str, result: dict, frames: int,
                         hw: tuple[int, int]):
    """An error-free envelope: a ``video/mp4`` primary of ``frames`` frames
    of ``hw`` (read back with OpenCV), a JPEG thumbnail of frame 0's size,
    and JAX's config keys. Returns the decoded frames."""
    from PIL import Image

    cfg = result["pipeline_config"]
    if "error" in cfg:
        raise AssertionError(f"{phase} {result['id']}: {cfg['error']}")
    primary = result["artifacts"]["primary"]
    thumb = result["artifacts"].get("thumbnail") or {}
    got = clip_frames(primary["blob"])
    jpeg = Image.open(io.BytesIO(base64.b64decode(thumb.get("blob", ""))))
    if (primary["content_type"] != "video/mp4"
            or thumb.get("content_type") != "image/jpeg"
            or jpeg.format != "JPEG" or jpeg.size != (hw[1], hw[0])
            or got.shape[:3] != (frames, *hw)):
        raise AssertionError(
            f"{phase} {result['id']}: {primary['content_type']} of "
            f"{got.shape}, thumbnail {thumb.get('content_type')} "
            f"{jpeg.format} {jpeg.size}; want video/mp4 of {frames} frames "
            f"of {hw} and a JPEG")
    if set(cfg) != VIDEO_CONFIG_KEYS[kind]:
        raise AssertionError(f"{phase} {result['id']}: config keys "
                             f"{sorted(set(cfg) ^ VIDEO_CONFIG_KEYS[kind])} "
                             "differ from JAX's")
    return got


@contextlib.contextmanager
def timed_container():
    """Host seconds of each ``workloads/video.py::_video_artifacts`` call
    (the container's encode, frame 0's JPEG and thumbnail)."""
    from chiaswarm_tpu_torch.workloads import video

    real, seconds = video._video_artifacts, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    video._video_artifacts = timed
    try:
        yield seconds
    finally:
        video._video_artifacts = real


def video_jobs_table(ids, by_id: dict, rows: dict, stages: dict | None,
                     container_s: list) -> dict:
    """Each served job's seconds (poll receipt to settled upload),
    ``generation_s`` and ``frames_per_sec``; the device ms of each stage
    (in the order the worker ran them) and the container's host seconds."""
    jobs = {}
    for job_id in ids:
        cfg = by_id[job_id]["pipeline_config"]
        jobs[job_id] = {"job_seconds": rows[job_id]["seconds"],
                        "generation_s": cfg.get("generation_s"),
                        "frames_per_sec": cfg.get("frames_per_sec")}
    return {"jobs": jobs, "stage_ms_each": None if stages is None
            else stages["ms_each"], "container_s_each": container_s}


def video_eval_gates(torch, pipe, rows: int, frames: int,
                     b1_launches: int) -> dict:
    """One UNet eval of ``pipe``'s family on the card (bf16, ``rows`` clips
    of ``frames`` frames at the family's default size, ``b1_launches`` B1
    launches) against the same eval on the plain route
    (``VIDEO_PLAIN_BAR``), and one at 2 frames and a 32x32 latent against a
    float32 CPU eval of the same weights (``VIDEO_CPU_BAR``)."""
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl
    from chiaswarm_tpu_torch.pipelines.video import make_video_unet

    fam = pipe.c.family
    cfg = fam.unet
    unet = pipe.c.unet
    gen = torch.Generator().manual_seed(7)

    def inputs(b: int, f: int, hw: int):
        sample = torch.randn((b, f, cfg.sample_channels, hw, hw),
                             generator=gen)
        ctx = torch.randn((b, 1 if fam.image_conditioned else 77,
                           cfg.cross_attention_dim), generator=gen)
        t = torch.full((b,), 0.5 if fam.image_conditioned else 500.0)
        ids = (torch.tensor([[6.0, 127.0, 0.02]] * b)
               if fam.image_conditioned else None)
        return sample, t, ctx, ids

    def run(module, args, device):
        sample, t, ctx, ids = (None if a is None else a.to(device)
                               for a in args)
        with torch.inference_mode():
            out = module(sample, t, ctx,
                         None if ids is None else {"time_ids": ids})
        return out.float().cpu()

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    served = inputs(rows, frames, fam.default_size // fam.vae.downscale)
    kernels.reset_launches()
    b1 = run(unet, served, "cuda")
    launches = kernel_launches()
    set_attn_impl(unet, "xla")
    try:
        plain = run(unet, served, "cuda")
    finally:
        set_attn_impl(unet, "auto")
    small = inputs(1, 2, 32)
    card = run(unet, small, "cuda")
    with torch.device("meta"):
        cpu_unet = make_video_unet(fam)
    cpu_unet = cpu_unet.to_empty(device="cpu")
    cpu_unet.load_state_dict(unet.state_dict(), strict=True)
    t0 = time.perf_counter()
    cpu = run(cpu_unet.eval(), small, "cpu")
    cpu_s = time.perf_counter() - t0
    del cpu_unet
    out = {"served_eval": {"shape": list(served[0].shape),
                           "b1_launches": launches["flash_attention"],
                           "rel_l2_vs_plain": rel(b1, plain),
                           "bar": VIDEO_PLAIN_BAR},
           "two_frames_vs_cpu_fp32": {"shape": list(small[0].shape),
                                      "rel_l2": rel(card, cpu),
                                      "max_abs_err": float(
                                          (card - cpu).abs().max()),
                                      "cpu_s": cpu_s, "bar": VIDEO_CPU_BAR}}
    check_b1(f"one {fam.name} eval", launches, b1_launches)
    if not rel(b1, plain) <= VIDEO_PLAIN_BAR:
        raise AssertionError(f"{fam.name}: B1 against the plain route: "
                             f"relative L2 {rel(b1, plain)}")
    if not rel(card, cpu) <= VIDEO_CPU_BAR:
        raise AssertionError(f"{fam.name}: the card against the CPU: "
                             f"relative L2 {rel(card, cpu)}")
    return out


def video_shares(b1_rows: list, run: dict, stages: dict) -> dict:
    """Device ms by stage over the served jobs, B1's ms (its launches by
    shape times the kernel phase's ms) and its shares of the denoise and of
    all stages."""
    totals = stages["ms"]
    share = b1_share(b1_rows, run, totals["denoise"])
    return {"stage_ms": totals, "device_ms": sum(totals.values()),
            "b1_ms": share["b1_ms"], "b1_share_of_denoise": share["b1_share"],
            "b1_share_of_device": share["b1_ms"] / sum(totals.values())}


def txt2vid_serve_phase(torch, registry, pool, b1_rows: list) -> dict:
    """ModelScope at its published widths, random from seed 0 through the
    registry's ``allow_random`` fallback; a hive txt2vid job at the defaults
    (256 px, 25 frames bucketed to 32, 25 steps, guidance 9.0, 8 fps), the
    same job again and one at guidance 1.0, through the worker. Gates: the
    envelopes, the repeat's frames bit for bit, B1 exactly 5 x evals at
    (64, 1024, 1024, 5, 64) and (32, ...) and no other kernel, one eval
    against the plain route and one against the CPU. Prints job seconds,
    ``generation_s``, ``frames_per_sec``, device ms by stage, B1's ms and
    share, launches an eval, the busy share and top kernels
    (``tools/torch_serve_profile.py``), the peak memory."""
    import numpy as np

    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.video import MODELSCOPE

    t0 = time.perf_counter()
    pipe = registry.video_pipeline(VIDEO_TXT_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if pipe.c.family != MODELSCOPE:
        raise AssertionError(f"txt2vid_serve: family {pipe.c.family.name}")
    params = {name: sum(p.numel() for p in m.parameters())
              for name, m in zip(("text_encoder", "unet", "vae"),
                                 pipe.c.modules())}
    stage_names = {"encode": "encode_text", "denoise": "denoise",
                   "decode": "decode"}
    with LocalHive() as hive:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with timed_stages(torch, pipe, stage_names) as stages, \
                timed_container() as container:
            worker = serve_through_worker(hive, pool, registry, TXT2VID_JOBS)
        run, launches = launched(), kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
    frames, want = {}, collections.Counter()
    for job in TXT2VID_JOBS:
        frames[job["id"]] = check_video_envelope(
            "txt2vid_serve", "txt2vid", by_id[job["id"]], 25, (256, 256))
        batch = 64 if job.get("guidance_scale", 9.0) > 1.0 else 32
        want[(batch, 1024, 1024, 5, 64, "bfloat16")] += VIDEO_B1_PER_EVAL * 25
    got = collections.Counter(run["flash_attention"]["shapes"])
    if got != want or sum(launches.values()) != launches["flash_attention"]:
        raise AssertionError(f"txt2vid_serve launched {launches} by shape "
                             f"{dict(got)}, want {dict(want)}")
    repeat_equal = bool(np.array_equal(frames["txt2vid-1"],
                                       frames["txt2vid-1-again"]))
    if not repeat_equal:
        raise AssertionError("txt2vid_serve: the same job twice differs")
    gates = video_eval_gates(torch, pipe, rows=2, frames=32,
                             b1_launches=VIDEO_B1_PER_EVAL)
    profile = profile_tool().video_profile(torch, pipe, "txt2vid",
                                           warm_up=False, top=8)
    emit("txt2vid_serve", load_s=load_s, params=params,
         param_bytes=pipe.c.param_bytes(),
         **video_jobs_table([j["id"] for j in TXT2VID_JOBS], by_id, rows,
                            stages, container),
         **video_shares(b1_rows, run, stages),
         launches_per_eval=launches["flash_attention"] / (3 * 25),
         launches=launches, b1_shapes=b1_shapes(run),
         repeat_frames_equal=repeat_equal, evals=gates, profile=profile,
         max_memory_allocated=peak, nvidia_smi=nvidia_smi_line())
    return run


def img2vid_serve_phase(torch, registry, pool, b1_rows: list) -> dict:
    """SVD at its published widths (the spatio-temporal UNet, ViT-H/14 as
    the image tower, the temporal VAE), random from seed 0 through the
    registry's fallback; a job from a start image served by this script's
    hive at the defaults (512 px, 14 frames bucketed to 16, motion bucket
    127, noise-aug 0.02, guidance 1.0 -> 3.0, ``IMG2VID_STEPS`` steps), the
    same job again and the same seed on another start image, through the
    worker. Gates: the envelopes, the repeat bit for bit, another start
    image other frames, B1 exactly 5 x evals at (32, 4096, 4096, 5, 64) and
    (32, 1024, 1024, 10, 64) and no other kernel, the eval gates. Prints
    txt2vid_serve's numbers."""
    import numpy as np

    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.video import SVD

    t0 = time.perf_counter()
    pipe = registry.video_pipeline(VIDEO_IMG_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if pipe.c.family != SVD:
        raise AssertionError(f"img2vid_serve: family {pipe.c.family.name}")
    params = {name: sum(p.numel() for p in m.parameters())
              for name, m in zip(("image_encoder", "unet", "vae"),
                                 pipe.c.modules())}
    stage_names = {"encode": "encode_image", "denoise": "denoise",
                   "decode": "decode"}
    with LocalHive() as hive:
        hive.assets.update({"svd-a.png": png_bytes(smooth_image(61, 512)),
                            "svd-b.png": png_bytes(smooth_image(62, 512))})
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with timed_stages(torch, pipe, stage_names) as stages, \
                timed_container() as container:
            worker = serve_through_worker(hive, pool, registry,
                                          on_hive(hive, IMG2VID_JOBS))
        run, launches = launched(), kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
    frames, want = {}, collections.Counter()
    for job in IMG2VID_JOBS:
        frames[job["id"]] = check_video_envelope(
            "img2vid_serve", "img2vid", by_id[job["id"]], 14, (512, 512))
        for shape in ((32, 4096, 4096, 5, 64), (32, 1024, 1024, 10, 64)):
            want[(*shape, "bfloat16")] += VIDEO_B1_PER_EVAL * IMG2VID_STEPS
    got = collections.Counter(run["flash_attention"]["shapes"])
    if got != want or sum(launches.values()) != launches["flash_attention"]:
        raise AssertionError(f"img2vid_serve launched {launches} by shape "
                             f"{dict(got)}, want {dict(want)}")
    repeat_equal = bool(np.array_equal(frames["img2vid-1"],
                                       frames["img2vid-1-again"]))
    other_differs = not np.array_equal(frames["img2vid-1"],
                                       frames["img2vid-b"])
    if not (repeat_equal and other_differs):
        raise AssertionError(f"img2vid_serve: repeat equal {repeat_equal}, "
                             f"another start image differs {other_differs}")
    gates = video_eval_gates(torch, pipe, rows=1, frames=16,
                             b1_launches=2 * VIDEO_B1_PER_EVAL)
    profile = profile_tool().video_profile(
        torch, pipe, "img2vid", steps=IMG2VID_STEPS, warm_up=False, top=8)
    emit("img2vid_serve", load_s=load_s, params=params,
         param_bytes=pipe.c.param_bytes(), steps=IMG2VID_STEPS,
         **video_jobs_table([j["id"] for j in IMG2VID_JOBS], by_id, rows,
                            stages, container),
         **video_shares(b1_rows, run, stages),
         launches_per_eval=(launches["flash_attention"]
                            / (3 * IMG2VID_STEPS)),
         launches=launches, b1_shapes=b1_shapes(run),
         repeat_frames_equal=repeat_equal,
         other_image_differs=other_differs, evals=gates, profile=profile,
         max_memory_allocated=peak, nvidia_smi=nvidia_smi_line())
    return run


def vid2vid_clip() -> tuple[bytes, list]:
    """``VID2VID_FRAMES`` frames of a smooth picture panning 8 px a frame,
    at ``VID2VID_HW``, as an mp4v clip at 24 fps (and the frames)."""
    import tempfile

    import cv2
    import numpy as np

    h, w = VID2VID_HW
    base = smooth_image(70, w)[:h]
    frames = [np.ascontiguousarray(np.roll(base, 8 * i, axis=1))
              for i in range(VID2VID_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "clip.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                                 24.0, (w, h))
        if not writer.isOpened():
            raise AssertionError("OpenCV cannot write mp4v on this node")
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        return path.read_bytes(), frames


def vid2vid_serve_phase(torch, registry, pool, b1_rows: list) -> dict:
    """The run's SD1.5 on a 12-frame 16:9 clip at 512 px height written
    with OpenCV and served over HTTP: a vid2vid job at strength 0.6 and 20
    steps (two chunks, 8 and 4 frames, 12 evals each) and the same job
    again, through the worker. Gates: the envelopes (12 frames of 512x910),
    the repeat bit for bit, B1 exactly 5 x evals at each of its four
    shapes and no other kernel, each frame's init latent its own encode
    (twelve a job, no two equal), and a one-frame stack the one-image
    img2img path bit for bit (direct calls). Prints job seconds, device ms
    of the encodes, the generate calls and the decodes, B1's ms and share,
    the container's host seconds and the peak memory. The generate calls'
    event ms hold the denoise and the decode; the encodes are outside them.
    vid2vid's UNet is SD1.5's, held against the plain route and in float32
    by the check phase."""
    import numpy as np

    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.diffusion import GenerateRequest

    pipe = registry.pipeline("sd15")
    clip, source = vid2vid_clip()
    with LocalHive() as hive:
        hive.assets["clip.mp4"] = clip
        hive.asset_types["clip.mp4"] = "video/mp4"
        jobs = [dict(job, video_uri=hive.uri + job["video_uri"])
                for job in VID2VID_JOBS]
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        stage_names = {"generate": "_generate"}
        with watch_pipe(torch, pipe) as encodes, \
                timed_stages(torch, pipe, stage_names) as stages, \
                timed_container() as container:
            worker = serve_through_worker(hive, pool, registry, jobs)
        run, launches = launched(), kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        by_id = {r["id"]: r for r in hive.results}
        rows = trace_rows(worker)
    frames = {job["id"]: check_video_envelope(
        "vid2vid_serve", "vid2vid", by_id[job["id"]], VID2VID_FRAMES,
        VID2VID_HW) for job in VID2VID_JOBS}
    start = round(VID2VID_STEPS * (1 - VID2VID_STRENGTH))
    evals = VID2VID_STEPS - start
    want = collections.Counter()
    for batch in (16, 8):  # the 8- and 4-frame chunks under CFG
        for shape in ((7680, 7680, 8, 40), (1920, 1920, 8, 80)):
            want[(batch, *shape, "bfloat16")] += \
                VIDEO_B1_PER_EVAL * evals * len(VID2VID_JOBS)
    got = collections.Counter(run["flash_attention"]["shapes"])
    if got != want or sum(launches.values()) != launches["flash_attention"]:
        raise AssertionError(f"vid2vid_serve launched {launches} by shape "
                             f"{dict(got)}, want {dict(want)}")
    repeat_equal = bool(np.array_equal(frames["vid2vid-1"],
                                       frames["vid2vid-1-again"]))
    latents = [z for z, _, _ in encodes["encodes"]]
    n_encodes = len(latents)
    distinct = all(not torch.equal(latents[i], latents[j])
                   for i in range(VID2VID_FRAMES)
                   for j in range(i + 1, VID2VID_FRAMES))
    cfg = by_id["vid2vid-1"]["pipeline_config"]
    if not (repeat_equal and distinct
            and n_encodes == VID2VID_FRAMES * len(VID2VID_JOBS)
            and cfg["frames"] == VID2VID_FRAMES
            and cfg["compute_cost"] == 512 * 512 * VID2VID_STEPS
            * VID2VID_FRAMES):
        raise AssertionError(f"vid2vid_serve: repeat equal {repeat_equal}, "
                             f"{n_encodes} encodes, distinct {distinct}, "
                             f"config {cfg}")
    # a one-frame stack against the one-image img2img path, direct calls
    h, w = VID2VID_HW
    req = dict(prompt="a watercolor painting", negative_prompt="blurry",
               steps=VID2VID_STEPS, guidance_scale=7.5, height=h, width=w,
               seed=1, strength=VID2VID_STRENGTH)
    one_image, _ = pipe(GenerateRequest(init_image=source[0], **req))
    one_frame, _ = pipe(GenerateRequest(init_image=source[0][None], **req))
    one_frame_equal = bool(np.array_equal(one_image, one_frame))
    if not one_frame_equal:
        raise AssertionError("vid2vid_serve: a one-frame stack differs from "
                             "the one-image img2img path")
    share = b1_share(b1_rows, run, stages["ms"]["generate"])
    emit("vid2vid_serve", frames=VID2VID_FRAMES, size=list(VID2VID_HW),
         steps=VID2VID_STEPS, strength=VID2VID_STRENGTH, evals_a_chunk=evals,
         **video_jobs_table([j["id"] for j in VID2VID_JOBS], by_id, rows,
                            None, container),
         encode_ms=sum(encodes["encode_ms"]),
         generate_ms=stages["ms"]["generate"], **share,
         launches_per_eval=(launches["flash_attention"]
                            / (evals * 2 * len(VID2VID_JOBS))),
         launches=launches, b1_shapes=b1_shapes(run),
         repeat_frames_equal=repeat_equal, init_latents_distinct=distinct,
         one_frame_equals_img2img=one_frame_equal,
         max_memory_allocated=peak, nvidia_smi=nvidia_smi_line())
    return run


CASCADE_MODEL = "DeepFloyd/IF-I-XL-v1.0"  # random, seed 0 (the fallback)
X4_MODEL = "stabilityai/stable-diffusion-x4-upscaler"  # the callback's default
CASCADE_PROMPT = "a photo of a red fox in fresh snow, detailed fur, 8k"
CASCADE_JOBS = [
    {"id": "if-1", "model_name": CASCADE_MODEL, "prompt": CASCADE_PROMPT,
     "negative_prompt": "blurry", "seed": 1, "content_type": "image/png"},
    {"id": "if-1-again", "model_name": CASCADE_MODEL,
     "prompt": CASCADE_PROMPT, "negative_prompt": "blurry", "seed": 1,
     "content_type": "image/png"},
    {"id": "if-nocfg", "model_name": CASCADE_MODEL, "prompt": CASCADE_PROMPT,
     "seed": 2, "guidance_scale": 1.0, "num_inference_steps": 20,
     "sr_steps": 10, "content_type": "image/png"},
]
#: B1 a job at the hive's defaults: 30 stage-2 evals x 11, 75 x4 evals x 16
B1_LAUNCHES_PER_CASCADE_JOB = 1530
# relative L2 of one bf16 UNet eval through B1 against the plain route
CASCADE_PLAIN_BAR = 3e-2
CASCADE_STAGES = {"t5": "encode_text", "stage1": "stage1",
                  "stage2": "stage2"}
X4_STAGES = {"x4_text": "encode_text", "x4_denoise": "denoise",
             "x4_decode": "decode"}


def unet_b1_shapes(cfg, hw: int, batch: int) -> collections.Counter:
    """B1's launches in one bf16 eval of a UNet of config ``cfg`` at a
    ``hw`` x ``hw`` input, by shape: a spatial self-attention per
    transformer block (``layers_per_block`` down, one more up, the mid
    block's at the last level) at each level whose grid has at least
    1,024 tokens."""
    shapes = collections.Counter()
    last = len(cfg.block_out_channels) - 1
    for level, ch in enumerate(cfg.block_out_channels):
        blocks = cfg.transformer_depth[level] * (2 * cfg.layers_per_block + 1)
        if level == last:
            blocks += max(cfg.transformer_depth) or 1
        tokens = (hw >> level) ** 2
        if blocks and tokens >= 1024:
            heads, head_dim = cfg.heads_for(ch, level)
            shapes[(batch, tokens, tokens, heads, head_dim,
                    "bfloat16")] += blocks
    return shapes


def cascade_b1_want(job: dict) -> collections.Counter:
    """B1's launches by shape for one cascade job, from the configs: the
    base (64 px: no level reaches 1,024 tokens), the super-resolution's
    ``sr_steps`` evals at 256 px, CFG batch 2 above guidance 1.0, and the
    x4 upscaler's 75 evals at a 256x256 latent, always under CFG."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.pipelines.cascade import IF_XL
    from chiaswarm_tpu_torch.pipelines.upscale import (
        DEFAULT_X4_GUIDANCE,
        DEFAULT_X4_STEPS,
    )

    cfg_batch = 2 if job.get("guidance_scale", 7.0) > 1.0 else 1
    want = collections.Counter()
    for unet, hw, batch, evals in (
            (IF_XL.stage1, IF_XL.base_size, cfg_batch,
             job.get("num_inference_steps", 50)),
            (IF_XL.stage2, IF_XL.sr_size, cfg_batch, job.get("sr_steps", 30)),
            (FAMILIES["upscaler_x4"].unet, IF_XL.sr_size,
             2 if DEFAULT_X4_GUIDANCE > 1.0 else 1, DEFAULT_X4_STEPS)):
        for shape, n in unet_b1_shapes(unet, hw, batch).items():
            want[shape] += n * evals
    return want


def release_models(torch, registry) -> dict:
    """Evict every model of ``registry``'s ledger (a squeeze to a zero
    budget, then the budget back) and return the cache to the card:
    ``memory_allocated`` before and after."""
    import gc

    ledger = registry.residency
    before = torch.cuda.memory_allocated()
    budget, hard = ledger.budget_bytes, ledger.hard_limit_bytes
    ledger.set_budget(0, hard)
    ledger.set_budget(budget, hard)
    gc.collect()
    torch.cuda.empty_cache()
    return {"memory_allocated_before": before,
            "memory_allocated_after": torch.cuda.memory_allocated()}


def cascade_check_phase(torch, registry) -> None:
    """The run's earlier models released (``release_models``); the cascade
    and the x4 upscaler drawn at their published widths through the
    registry's random fallback (they stay resident for cascade_serve). One
    bf16 eval of the stage-2 UNet at a 256 px input and of the x4 UNet at
    a 256x256 latent with its class label, each through B1 (11 and 16
    launches) against the plain route (``CASCADE_PLAIN_BAR``); one prompt
    through the full-width T5-XXL in bf16 (finite embeddings); one x4 VAE
    decode at a 256x256 latent (its mid block attends over 65,536 tokens on
    the plain path, in blocks of queries): its ms and its peak
    ``max_memory_allocated`` over the level before."""
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.pipelines.cascade import IF_XL
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    released = release_models(torch, registry)
    t0 = time.perf_counter()
    pipe = registry.cascade_pipeline(CASCADE_MODEL)
    torch.cuda.synchronize()
    cascade_draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    up = registry.pipeline(X4_MODEL)
    torch.cuda.synchronize()
    x4_draw_s = time.perf_counter() - t0
    params = {name: sum(p.numel() for p in m.parameters())
              for name, m in (("t5", pipe.c.t5), ("stage1", pipe.c.unet1),
                              ("stage2", pipe.c.unet2),
                              ("x4_unet", up.c.unet), ("x4_vae", up.c.vae),
                              ("x4_text", up.c.text_encoders[0]))}
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to("cuda")

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    def eval_gate(name: str, unet, want: collections.Counter, *args,
                  **kwargs) -> dict:
        kernels.reset_launches()
        with torch.inference_mode():
            b1 = unet(*args, **kwargs).float()
        run, launches = launched(), kernel_launches()
        set_attn_impl(unet, "xla")
        try:
            with torch.inference_mode():
                plain = unet(*args, **kwargs).float()
        finally:
            set_attn_impl(unet, "auto")
        got = collections.Counter(run["flash_attention"]["shapes"])
        out = {"shape": list(args[0].shape), "b1_launches": launches,
               "b1_shapes": b1_shapes(run), "rel_l2_vs_plain": rel(b1, plain),
               "bar": CASCADE_PLAIN_BAR, "finite": bool(b1.isfinite().all())}
        check_b1(name, launches, sum(want.values()))
        if got != want or not out["finite"] \
                or not out["rel_l2_vs_plain"] <= CASCADE_PLAIN_BAR:
            raise AssertionError(f"cascade_check {name}: {out}, want {want}")
        return out

    t = torch.full((2,), 500.0, device="cuda")
    stage2 = eval_gate("stage2", pipe.c.unet2,
                       unet_b1_shapes(IF_XL.stage2, 256, 2),
                       randn(2, 6, 256, 256), t, randn(2, 77, 4096))
    x4 = eval_gate("x4", up.c.unet,
                   unet_b1_shapes(up.c.family.unet, 256, 2),
                   randn(2, 7, 256, 256), t, randn(2, 77, 1024),
                   class_labels=torch.full((2,), 20, device="cuda"))
    ids = pipe.c.tokenizer.encode_batch([CASCADE_PROMPT])
    with torch.inference_mode():
        emb = pipe.encode_text(ids, None)
    torch.cuda.synchronize()
    t5 = {"shape": list(emb.shape), "dtype": str(emb.dtype),
          "finite": bool(emb.isfinite().all()),
          "std": float(emb.std()), "max_abs": float(emb.abs().max()),
          "t5_dtype": str(pipe.c.t5.shared.weight.dtype)}
    z = randn(1, 4, 256, 256)
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with torch.inference_mode():
        img = up.c.vae.decode(z)
    end.record()
    torch.cuda.synchronize()
    decode = {"latent": list(z.shape), "image": list(img.shape),
              "ms": start.elapsed_time(end),
              "peak_over_level_bytes": torch.cuda.max_memory_allocated()
              - level, "finite": bool(img.isfinite().all())}
    emit("cascade_check", **released, cascade_draw_s=cascade_draw_s,
         x4_draw_s=x4_draw_s, params=params,
         param_bytes={"cascade": pipe.c.param_bytes(),
                      "x4": up.c.param_bytes()},
         stage2_eval=stage2, x4_eval=x4, t5=t5, x4_decode=decode,
         nvidia_smi=nvidia_smi_line())
    if not (t5["finite"] and t5["shape"] == [1, 77, 4096]):
        raise AssertionError(f"cascade_check: T5-XXL in bf16 gave {t5}")
    if decode["image"] != [1, 3, 1024, 1024] or not decode["finite"]:
        raise AssertionError(f"cascade_check: the x4 decode gave {decode}")


def cascade_serve_phase(torch, registry, slot, b1_rows: list) -> dict:
    """DeepFloyd jobs through ``synchronous_do_work`` (``CASCADE_JOBS``: the
    hive's defaults, 50 base and 30 super-resolution steps at guidance
    7.0 then the x4 upscaler's 75 steps at 9.0, twice; and a guidance-1.0
    job at 20 and 10 steps), the models of cascade_check. Gates: each
    envelope error-free with a 1024x1024 PNG and the cascade's config
    (three stages, the x4 keys); the repeat bit for bit; B1 exactly
    ``cascade_b1_want`` by shape a job (1,530 at the defaults), B2 and B3
    never. Prints each job's seconds, ``generation_s``, device ms by stage
    (T5, stage 1, stage 2, the x4's text, denoise and decode), B1's ms and
    share of the device ms and the peak memory; then the default job under
    ``tools/torch_serve_profile.py``'s ``cascade_profile`` (busy share, B1's
    share, top kernels)."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels

    pipe = registry.cascade_pipeline(CASCADE_MODEL)
    up = registry.pipeline(X4_MODEL)
    jobs, blobs = {}, {}
    total = collections.Counter()
    kernels.reset_launches()
    with timed_stages(torch, pipe, CASCADE_STAGES) as stages, \
            timed_stages(torch, up, X4_STAGES) as x4_stages:
        for job in CASCADE_JOBS:
            before = launched()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = synchronous_do_work(dict(job), slot, registry)
            seconds = time.perf_counter() - t0
            after = launched()
            cfg = result["pipeline_config"]
            blobs[job["id"]] = check_envelope(
                "cascade_serve", dict(job, height=1024, width=1024), result,
                False)
            want_cfg = {"mode": "cascade_txt2img", "stages": 3,
                        "stage3_passes": 1, "size": [1024, 1024],
                        "upscaler": X4_MODEL, "scale": 4,
                        "upscale_steps": 75, "upscale_noise_level": 20,
                        "steps": job.get("num_inference_steps", 50),
                        "sr_steps": job.get("sr_steps", 30)}
            if any(cfg.get(k) != v for k, v in want_cfg.items()):
                raise AssertionError(f"cascade_serve {job['id']}: {cfg}")
            got = collections.Counter({
                k: n - before["flash_attention"]["shapes"].get(k, 0)
                for k, n in after["flash_attention"]["shapes"].items()})
            got = +got
            others = {name: after[name]["launches"] - before[name]["launches"]
                      for name in after if name != "flash_attention"}
            want = cascade_b1_want(job)
            if got != want or any(others.values()):
                raise AssertionError(
                    f"cascade_serve {job['id']}: B1 by shape {dict(got)}, "
                    f"want {dict(want)}; others {others}")
            total += got
            jobs[job["id"]] = {"job_seconds": seconds,
                               "generation_s": cfg["generation_s"],
                               "b1_launches": sum(got.values()),
                               "max_memory_allocated":
                               torch.cuda.max_memory_allocated()}
    if sum(cascade_b1_want(CASCADE_JOBS[0]).values()) != \
            B1_LAUNCHES_PER_CASCADE_JOB:
        raise AssertionError("cascade_serve: the default job's B1 count is "
                             "not 1,530")
    run = launched()
    ms_each = {**stages["ms_each"], **x4_stages["ms_each"]}
    b1_ms = {shape_key(r): r["ms"] for r in b1_rows}
    for i, job in enumerate(CASCADE_JOBS):
        row = jobs[job["id"]]
        row["stage_ms"] = {stage: ms[i] for stage, ms in ms_each.items()}
        row["device_ms"] = sum(row["stage_ms"].values())
        row["b1_ms"] = sum(n * b1_ms[k] for k, n in
                           cascade_b1_want(job).items())
        row["b1_share_of_device"] = row["b1_ms"] / row["device_ms"]
    repeat_equal = blobs["if-1"] == blobs["if-1-again"]
    if not repeat_equal:
        raise AssertionError("cascade_serve: the same job twice differs")
    profile = profile_tool().cascade_profile(torch, pipe, up, warm_up=False,
                                             top=8)
    emit("cascade_serve", jobs=jobs, repeat_png_equal=repeat_equal,
         launches={name: r["launches"] for name, r in run.items()},
         b1_shapes=b1_shapes(run), profile=profile,
         nvidia_smi=nvidia_smi_line())
    return run


def kernel_entry(name: str, rows: list[dict], run: dict, **extra) -> dict:
    """One kernel of the kernels line: its launches in a served phase
    (``run``, from ``launched``) and its per-launch numbers from its kernel
    phase averaged over that phase's launches by shape."""
    from chiaswarm_tpu_torch.ops.kernels import KERNELS

    k = KERNELS[name]
    weights = [run[name]["shapes"].get(shape_key(r), 0) for r in rows]

    def mix(key):
        values = [r[key] for r in rows]
        if any(v is None for v in values):
            return None
        return sum(w * v for w, v in zip(weights, values)) / sum(weights)

    op_ms = sum(w * r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3
                for w, r in zip(weights, rows))
    byte_ms = sum(w * r["bytes"] / PEAK_BYTES_PER_S * 1e3
                  for w, r in zip(weights, rows))
    served = [r["design"] for r, w in zip(rows, weights) if w]
    return {
        "name": name, "route": "cuda",
        "source": str(k.source.relative_to(ROOT)),
        "replaces": k.replaces,
        "design": ", ".join(dict.fromkeys(served)) if served else None,
        "launches": run[name]["launches"],
        "launches_by_shape": weights,
        "checked_against_plain": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mix("ms"), "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound_ms"),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": mix("library_ms"),
        "vs_library": vs_library(mix("ms"), mix("library_ms")),
        **extra,
    }


def kernels_line(runs: dict, tables: dict) -> None:
    """Each kernel on its solo serve phase, with the lane phases that
    launch it beside (their launches and numbers over their shapes); the
    per-shape numbers under ``shapes``, in the order of
    ``launches_by_shape``."""
    def entry(name, phase, lanes=(), **extra):
        for lane in lanes:
            extra[lane] = kernel_entry(name, tables[name], runs[lane])
            for key in ("name", "route", "source", "replaces",
                        "checked_against_plain", "max_abs_err"):
                del extra[lane][key]
        return {**kernel_entry(name, tables[name], runs[phase], **extra),
                "shapes": tables[name]}

    entries = [
        entry("flash_attention", "serve", ("lane_serve", "lane_burst",
                                           "checkpoint_serve",
                                           "residency_churn",
                                           "img2img_serve",
                                           "img2img_lane_serve",
                                           "img2img_pair", "inpaint_serve",
                                           "inpaint_lane_serve",
                                           "worker_serve", "xl_serve",
                                           "xl_lane_serve", "xl_lane_burst",
                                           "xl_worker_checkpoint",
                                           "xl_img2img_serve",
                                           "xl_img2img_lane_serve",
                                           "guard_lane", "guard_nan",
                                           "guard_solo", "guard_worker",
                                           "guard_cost", "guard_xl",
                                           "safety_serve",
                                           "controlnet_serve",
                                           "xl_controlnet_serve",
                                           "preprocess_serve",
                                           "pix2pix_serve",
                                           "upscale_serve",
                                           "xl_upscale_serve",
                                           "adapters_serve",
                                           "audio_serve", "txt2vid_serve",
                                           "img2vid_serve",
                                           "vid2vid_serve",
                                           "cascade_serve")),
        entry("ring_flash_hop", "seq_serve_scan",
              library_note="no single PyTorch call computes one ring hop "
                           "with carried state; the whole ring, scan drive "
                           "included, is timed beside "
                           "scaled_dot_product_attention under "
                           "ring_flash_fused"),
        entry("ring_flash_fused", "seq_serve", ("lane_seq_serve",
                                                "seq_img2img"),
              library_note="scaled_dot_product_attention on the unsharded "
                           "attention"),
    ]
    print(json.dumps({"kernels": entries}), flush=True)


def main() -> int:
    import shutil

    t0 = time.perf_counter()
    torch = probe()
    # everything this run writes (checkpoints, residency.json, spools)
    # stays under the checkout and is removed when the run ends
    root = settings_root_dir()
    shutil.rmtree(root, ignore_errors=True)
    os.environ["SWARM_TPU_ROOT"] = str(root)
    try:
        return run_phases(torch, t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_phases(torch, t0: float) -> int:
    build()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    b1_rows = kernel_phase(torch)
    b2_rows = ring_kernel_phase(torch)
    b3_rows = fused_kernel_phase(torch)
    check_phase(torch)
    xl_check_phase(torch)
    lane_check_phase(torch)
    ring_check_phase(torch)
    # serve with PyTorch's defaults, as a worker would
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.registry import ModelRegistry

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"},
                                      {"name": XL_MODEL, "family": "sdxl"}],
                             allow_random=True, device="cuda")
    pool = ChipPool(device="cuda")
    slot = pool.slots[0]
    runs = {}
    with env(CHIASWARM_STEPPER="0"):  # the solo path
        runs["serve"], solo_blobs = serve_phase(torch, registry, slot)
        runs["seq_serve"] = seq_serve_phase(torch, "seq_serve", solo_blobs)
        runs["seq_serve_scan"] = seq_serve_phase(torch, "seq_serve_scan",
                                                 solo_blobs)
    with env(CHIASWARM_STEPPER="1"):  # the lanes, the default engine
        runs["lane_serve"], lane_blobs, lane_spans = lane_serve_phase(
            torch, registry, slot, solo_blobs)
        runs["lane_burst"], burst_blobs, burst_ips = lane_burst_phase(
            torch, registry, slot)
        runs["lane_seq_serve"] = lane_seq_serve_phase(torch)
        runs["solo_pair"] = solo_pair_phase(torch, registry, slot,
                                            lane_blobs[1], solo_blobs[1])
        runs["checkpoint_serve"], ckpt = checkpoint_serve_phase(
            torch, registry, slot, lane_blobs, lane_spans)
        runs["residency_churn"] = residency_churn_phase(torch, slot, ckpt)
        # img2img and inpaint, their images fetched from a hive here
        with LocalHive() as asset_hive:
            asset_hive.assets.update(image_assets())
            img_runs, img_solo_blobs, img_blobs = img2img_serve_phase(
                torch, registry, slot, asset_hive)
            inpaint_runs, inpaint_blobs = inpaint_serve_phase(
                torch, registry, slot, asset_hive)
            runs.update(img_runs, **inpaint_runs)
            runs["seq_img2img"] = seq_img2img_phase(torch, asset_hive,
                                                    img_solo_blobs[31])
        runs["worker_serve"] = worker_serve_phase(
            torch, registry, pool, lane_blobs, burst_blobs, burst_ips, ckpt,
            {**img_blobs, **inpaint_blobs})
        # the gray-failure guard: a wedged lane, a NaN row, a hung solo
        # call, the healing ladder, and what the checkpoints cost
        with LocalHive() as asset_hive:
            asset_hive.assets.update(image_assets())
            runs["guard_lane"] = guard_lane_phase(torch, registry, slot,
                                                  asset_hive)
        runs["guard_nan"] = guard_nan_phase(torch, registry, pool)
        runs["guard_solo"] = guard_solo_phase(torch, registry, pool,
                                              solo_blobs[1])
        runs["guard_worker"] = guard_worker_phase(torch, registry, pool)
        with LocalHive() as child_hive:
            emit("guard_child", **guard_child(child_hive,
                                              settings_root_dir()))
        runs["guard_cost"] = guard_cost_phase(torch, registry, slot)
    # SDXL at 1024 px: the solo path, then the lanes and the worker
    with env(CHIASWARM_STEPPER="0"):
        runs["xl_serve"], xl_blobs, xl_ips = xl_serve_phase(torch, registry,
                                                            slot)
    with env(CHIASWARM_STEPPER="1"):
        runs["xl_lane_serve"], xl_lane_blobs = xl_lane_serve_phase(
            torch, registry, slot, xl_blobs)
        runs["xl_lane_burst"] = xl_lane_burst_phase(torch, registry, slot,
                                                    xl_ips)
        runs["xl_worker_checkpoint"] = xl_worker_checkpoint_phase(
            torch, registry, pool, xl_lane_blobs)
        with LocalHive() as asset_hive:
            asset_hive.assets.update(image_assets())
            runs.update(xl_img2img_serve_phase(torch, registry, slot,
                                               asset_hive))
        runs["guard_xl"] = guard_xl_phase(torch, registry, slot)
    # the safety checker and ControlNet, SD1.5 and SDXL
    checker = safety_check_phase(torch)
    runs["safety_serve"] = safety_serve_phase(torch, registry, slot, checker,
                                              solo_blobs)
    with LocalHive() as control_hive:
        control_hive.assets.update(control_assets())
        runs["controlnet_serve"] = controlnet_serve_phase(
            torch, registry, pool, slot, control_hive)
        runs["xl_controlnet_serve"] = xl_controlnet_serve_phase(
            torch, registry, slot, control_hive)
        # the learned preprocessors: their detectors on the card, then
        # their jobs through the SD1.5 ControlNet
        preprocess_check_phase(torch)
        runs["preprocess_serve"] = preprocess_serve_phase(
            torch, registry, slot, control_hive)
    # instruct-pix2pix, the x2 upscale pass, LoRA and textual inversion
    with env(CHIASWARM_STEPPER="1"):
        runs["pix2pix_serve"] = pix2pix_serve_phase(torch, registry, pool,
                                                    slot)
        runs["upscale_serve"] = upscale_serve_phase(torch, registry, pool,
                                                    slot, b1_rows)
        runs["xl_upscale_serve"] = xl_upscale_serve_phase(torch, registry,
                                                          slot, b1_rows)
        runs["adapters_serve"] = adapters_serve_phase(torch, registry, slot,
                                                      solo_blobs[1])
        # stitch, img2txt and txt2audio, their models loaded with no random
        # fallback
        strict = ModelRegistry(allow_random=False, device="cuda")
        runs["stitch_serve"] = stitch_serve_phase(torch, strict, pool)
        runs["caption_serve"] = caption_serve_phase(torch, strict, pool)
        runs["audio_serve"] = audio_serve_phase(torch, strict, pool, b1_rows)
        del strict
        torch.cuda.empty_cache()
        # text to speech: Bark's three GPT stages and the EnCodec decode
        runs["tts_serve"] = tts_serve_phase(torch, registry, pool)
        # video: txt2vid (ModelScope), img2vid (SVD), vid2vid (SD1.5)
        runs["txt2vid_serve"] = txt2vid_serve_phase(torch, registry, pool,
                                                    b1_rows)
        runs["img2vid_serve"] = img2vid_serve_phase(torch, registry, pool,
                                                    b1_rows)
        runs["vid2vid_serve"] = vid2vid_serve_phase(torch, registry, pool,
                                                    b1_rows)
    encode_check_phase(torch, registry)
    # the DeepFloyd cascade, after every earlier model is released
    cascade_check_phase(torch, registry)
    runs["cascade_serve"] = cascade_serve_phase(torch, registry, slot, b1_rows)
    tables = {"flash_attention": b1_rows, "ring_flash_hop": b2_rows,
              "ring_flash_fused": b3_rows}
    check_held(runs, tables)
    emit("script_wall", seconds=time.perf_counter() - t0)
    kernels_line(runs, tables)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
