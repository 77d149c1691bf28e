#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero:
  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build   - nvcc builds the nine kernels from reversible_raytracer_tpu_torch/
               ops/kernels/csrc (one process per source, all started
               together), and with them the contracted builds of phase 7.
  3. render  - the forward render kernel against its plain version (eager
               torch on the same card): config 2 at 512^2, config 3 at 512^2
               (two lights, two visibility planes), config 1 at 64^2 (no
               shadows, no planes) and 23 spheres of config 5 with its ground
               at 512^2 (24 objects, the most the kernel takes). The image bit
               for bit, the planes bit for bit on the pixels that hit an
               object and 0 where the ray hits nothing
               (the plain version's planes hold the shadow test of a ray cast
               from the BIG sentinel there, and nothing reads them); and the
               rule of tests/test_render_vs_oracle.py, printed beside (fewer
               than 0.1% of pixel-channels off by more than 2e-3, a mean
               error under 1e-4).
  4. step    - the fused step kernel against autograd and against the eager
               hand-written adjoint, config 2 at 512^2 from
               perturb(scale=0.1, seed=4): loss within 1e-4 relative, every
               gradient leaf within 1e-2 of the leaf's scale; three calls
               bit-identical.
  5. main    - the port's CLI: invert --config 2 --size 512 --iters 50 on the
               card (each step one replay of `optim.make_step`'s CUDA graph),
               with the launch counts read around it and the loop's ms a step
               (the first step's capture included).
  6. times   - each kernel and its plain version at 512^2 with CUDA events
               (median of 20 after warm-up), beside the kernel's bound; and
               each kernel's device time by launch and its launches per call
               (torch.profiler's CUDA activity over 20 calls: `device`); the
               step kernel must make one launch a call. The forward also at
               config 3 and at 24 objects, 512^2 (`render_shapes`: events and
               device time).
  7. fmad    - both kernels built as the port builds them (--fmad=false)
               and with nvcc's default FMA contraction, timed on the same
               inputs, and the contracted build's distance from the plain
               version (reported, not held).
  8. vec_render - the object-chunked forward kernel against its plain
               version (render_vec_plain) by the same rules as phase 3, on
               config 5 (64 spheres + ground) at 1024^2 and on bench.py's
               513-object shape (512 spheres + ground) at 512^2; the image
               and the planes on hit pixels must be bit-identical
               (`bit_identical`: the per-warp culls keep the full walks'
               bits) and the planes 0 where the ray hits nothing; the culls'
               counters (`cull`, as phase 11 prints them).
  9. vec_step - the object-chunked step kernel against autograd
               (loss_grad_vec_plain) and the eager adjoint at both shapes,
               from perturb(scale=0.05, seed=4): loss within 1e-4 relative,
               every leaf within 1e-2 of its scale; two calls bit-identical;
               and against the vec forward kernel's own image of the same
               scene (the true one, and perturb seeds 0-2) a loss of exactly
               0 and every gradient exactly 0 (the step's culled walks give
               the forward's full walks' bits); the most spheres a block of
               this card takes with config 5's rect and light, in rows 5-6
               and in row 4 (at least 1520 and 3392, what they took before
               the culls, on a card with the H100's 227 KB a block).
 10. vec_main - the port's CLI: invert --config 5 --size 1024 --iters 20 on
               the card, with the launch counts read around it and the loop's
               ms a step.
 11. vec_times - both vec kernels and their plain versions at the two shapes
               of phase 8 (CUDA events, median of 20 after warm-up), beside
               their bounds (with the per-warp culls, and without them as
               before: `render_bound_uncull`, `step_bound_uncull`) and row
               4's device time by launch (`render_device`); the culls'
               counters: candidate visits per warp walk, and the (pixel,
               sphere) pairs they keep against all pairs, for the primary
               and the shadow rays.
 12. soft_render - the soft forward kernel (soft_tau > 0) against its plain
               version (render_vec_soft_plain) by the rule of phase 3, on
               config 5 at 512^2 and 1024^2 at tau 0.08 and 0.01 and on the
               513-object shape at 512^2 (tau 0.08), with shadows; whether
               the images are bit-identical, and the culls' counters
               (`cull`: the ranking's widened cone, the shadow candidates).
 13. soft_step - the soft step kernel against autograd of the plain version
               and against the eager adjoint at the shapes of phase 12, from
               perturb(scale=0.05, seed=4): loss within 1e-4 relative, every
               leaf within 1e-2 of its scale; two calls bit-identical; and
               against the soft forward kernel's own image of the true scene
               a loss of exactly 0 and every gradient exactly 0 (the step's
               culled forward is the forward kernel's, bit for bit); the
               most spheres a block of this card takes with config 5's rect
               and light in rows 8-9 and in row 7 (at least 3392).
 14. anneal_main - the port's CLI: invert --config 5 --size 1024 --anneal
               0.08,0.03,0.01,0 --anneal-size 512 --lr 2e-3 --perturb 0.03
               --iters 20 on the card, with the launch counts read around it:
               the soft forward 3 times (the stage targets), the soft step
               60, the vec step 20, the vec forward at least twice, rows 1-2
               never; each soft stage's loss falls; the final parameter RMS
               is below the start's; the loop's ms a step (each stage runs
               through `optim.optimize_scan`: graph replays).
 15. soft_times - both soft kernels and their plain versions at config 5
               (512^2 and 1024^2, tau 0.08) and at 513 objects (512^2), with
               CUDA events (median of 20 after warm-up), beside their bounds
               (with the culls, and without them as before); row 7's device
               time by launch; the (pixel, sphere, layer, light) shadow pairs
               the cull keeps against all pairs, and the warps' candidate
               visits, for the shadows and for row 7's ranking.
 16. render_grad - the three render backward kernels (rows 3, 5, 8) at config
               2 512^2, config 5 1024^2 and config 5 512^2 tau 0.08, from
               perturb(seed=4): each against its plain version (autograd of
               the eager render) for a seeded normal cotangent, and row 8
               against its eager twin, every leaf within 1e-2 of its scale;
               the mse gradient of a differentiable `render` against the
               matching step kernel's (rows 1, 6, 9), by the same rule, and
               bit-equal for rows 3 and 1 and rows 5 and 6 (one body, one
               grid); three calls bit-identical; an expanded (stride-0)
               cotangent, from
               `render(...).sum().backward()`, bit-identical to its
               contiguous copy.
 17. render_grad_main - 20 steps of optimize(render_fn=render) on each of the
               three shapes (the JAX package's make_step route): the forward
               kernel 21 times (the target and one per step), the backward
               20, the step kernels and every other kernel never; the loss
               falls.
 18. render_grad_times - each backward kernel, its plain version, the forward
               and backward together, and the matching step kernel at the
               three shapes (CUDA events, median of 20 after 3 warm-ups),
               beside the backward's bound (row 5's with the primary cull,
               and without it as before); the backward's device time by
               launch and its launches per call, as in phase 6
               (`bwd_device`; row 3 must make one launch a call).
 19. loop    - the training loop eager (`optim.make_eager_step`, every launch
               from the host) and captured (`optim.make_step`, one CUDA graph
               replay a step) from the same start: config 2 at 512^2 (row 1,
               50 steps), config 5 at 1024^2 (row 6, 20 steps), config 5 at
               512^2 tau 0.08 (row 9, 20 steps), and config 2 at 512^2 by
               autograd of `render` (rows 2+3, 20 steps). The per-step losses
               and the final trainable vector bit for bit; `optimize_scan` in
               chunks of 7 bit for bit one chunk; one launch of each kernel a
               step in both loops; the host ms a step of each loop (the card
               synchronized at both ends: the first step, which captures the
               graph, apart from the rest, and the whole loop); and the
               device's idle share over 7 more steps of each, 1 - the kernels'
               device time (tools/kernel_timing.py) / the host wall time.
 20. checker - the soft checker (checker_tau > 0) in rows 7, 8 and 9 at
               config 4 (checker materials + camera pose), 512^2, tau 0.08,
               checker_tau 1.0: row 7 by the rule of phase 3; rows 9 and 8
               (by autograd of `render`) against autograd and their eager
               twins, every leaf within 1e-2 of its scale (the camera's eye,
               look_at and up on the largest of the three), the checker
               columns and the eye's gradient not 0; three calls
               bit-identical; row 9 against row 7's own image a loss of
               exactly 0; the three rows' soft-checker instances on config 5
               bit for bit the others; each row's event and device time,
               plain version and bound.
 21. checker_main - the port's CLI on config 4: invert --anneal 0.08,0.03,0
               --checker-ratio 12.5 --lr 5e-3 --iters 100 --perturb 0.05 at
               512^2 and 64^2 (row 9 200 times, row 7 twice, row 1 100 times
               for the hard polish, row 2 twice), and invert --iters 50 at
               512^2 (row 1 50 times, row 2 twice); each stage's first and
               last loss, the eye's RMS error at the start and the end (at
               64^2 it must end below 0.02 of its start) and the loop's ms a
               step.
 22. spp4    - rows 1-8 at spp 4 (2x2 supersampling) at each family's
               full-width shape: config 2 at 512^2 (rows 1-3), config 5 at
               1024^2 (rows 4-6), config 5 at 512^2, tau 0.08 (rows 7-8),
               reached as the main path reaches them, by the rules of phases
               3, 4, 9, 13 and 16: rows 2 and 4 bit for bit their plain
               versions (the image; each subsample's planes on the pixels its
               ray hit, 0 where it hit nothing), row 7 within 1e-6; rows 1
               and 6 against autograd and their eager twins and, given the
               forward kernel's own spp-4 image, a loss and every gradient of
               exactly 0; rows 3, 5 and 8 (autograd of `render`) against
               autograd of the plain render and their twins; the wrappers'
               launches a call (one for rows 1, 2, 3 and 6, four for rows 4,
               5, 7 and 8); two calls bit-identical; row 9 refuses spp 4 by
               name. Each row's event time, device time and launches per call
               on its C entries, its plain version's time and its bound
               (`spp_work`: every pixel's work four times, the scene's once).
 23. spp4_main - the CLI at --spp 4: `render` on configs 1-10; invert --config
               2 --size 512 --iters 50 (row 1 50 times, row 2 twice); invert
               --config 5 --size 1024 --iters 20 (row 6 20, row 4 8); the
               anneal of phase 14 at spp 4 (row 7 12 + 4 x 60 times, row 8 4 x
               60 by autograd of the four-launch soft render in each soft
               step's CUDA graph, row 9 never, row 6 20, row 4 8); every
               stage's loss falls; the host ms a step.
 24. mirror  - one mirror bounce (reflections 1) in rows 1-3 at config 6
               (a chrome sphere, a diffuse one, a reflective checkered floor),
               512^2, from perturb(scale=0.3, seed=3) of its mirror
               coefficients: row 2 bit for bit `render_fused_plain` (the
               image; 2 L planes, level 0's on the pixels the primary ray hit
               and level 1's where both levels hit, 0 elsewhere); row 1 given
               row 2's image of the true scene a loss and gradient of exactly
               0, and from the true scene (the diffuse sphere's coefficient 0)
               against row 2's image of perturb seed 1 (0.246 there) that
               coefficient's gradient not 0 and within 1e-2 of autograd's;
               row 1 against autograd and its eager twin, row 3 (by
               autograd of `render`) against autograd of the plain render and
               its twin for a unit normal cotangent (every leaf within 1e-2 of
               its scale, the largest difference printed); row 3's mse
               gradient row 1's bit for bit; one wrapper launch a call; two
               calls bit-identical. Each row's event time, device time and
               launches per call on its C entries, its plain version's time
               and its bound (`bounce_counts`: the reflected rays' walks,
               shading, shadow rays and adjoint counted in `OPS`).
 25. mirror_main - the CLI on config 6: `render --config 6` (row 2 once);
               invert --config 6 --perturb 0.3 --lr 2e-2 --iters 150 --seed 3
               at 512^2 and at 48^2 (row 1 150 times, row 2 twice; the mirror
               coefficients' RMS error from its start, about 0.19, below
               1e-3); 20 steps of optimize(render_fn=render) at 512^2 (row 2
               21 times, row 3 20); `render --config 5 --reflections 4` (four
               bounces, in rows 4-6) and `invert --config 6 --anneal 0.05,0`
               each raising by name, no kernel launched but the target's row
               2.
 26. texture - rows 1-3's textured instances (TEX: object textures, the
               environment map, spp 1) at configs 7 (a textured floor), 8 (a
               textured globe) and 9 (a sky environment map, one bounce),
               512^2, from perturb(scale=0.4, seed=0) of their texels: row 2
               bit for bit `render_fused_plain` (the image; the planes on the
               pixels each level hit, 0 elsewhere); row 1 given row 2's image
               of the truth a loss and gradient of exactly 0, and against
               autograd and its eager twin (every leaf within 1e-2 of its
               scale, the texels' largest difference printed); row 3 (by
               autograd of `render`) against autograd of the plain render and
               its twin for a unit normal cotangent, its mse gradient row 1's
               bit for bit; one wrapper launch a call; two calls
               bit-identical. Each row's event time, device time and launches
               per call on the C entries (rrt_*_tex), its plain version's time
               and its bound (`texture_bounds`: the texel reads, the bilinear
               weights and mix and the lat-long coordinates counted in
               `TEX_OPS` a sampling pixel).
 27. texture_main - the CLI on configs 7, 8 and 9: `render` (row 2 once);
               invert --lr 3e-2 --perturb 0.4 --iters 200 (the JAX package's
               recipe) at 512^2 and 64^2 (row 1 200 times, row 2 twice; every
               loss falls; at 64^2 the JAX tests' criteria: a final loss below
               1e-5 and the observable texels' RMS error below 0.25 / 0.3 /
               0.3 of its start, `observable_texels`); 20 steps of
               optimize(render_fn=render) on each at 512^2 (row 2 21 times,
               row 3 20); `render --config 7 --spp 4` (row 2 once, a PNG); and
               four refusals by name (`render --config 8 --reflections 4`, the
               same at --spp 4, `invert --config 7 --anneal 0.05,0
               --checker-ratio 12.5`: the soft checker beside a texel grid,
               `invert --config 9 --anneal 0.05,0`: its bounce under a soft
               stage).
 28. chrome  - rows 4-6's environment-map and bounce instances (the ``_levels``
               entries: level 1 over every sphere, its shadow rays culled,
               the env ending the globals) at config 10 (64 chrome spheres
               under a 16 x 16 sky, one bounce), 512^2, from perturb(scale=0.2,
               seed=10) of its mirror coefficients and sky, and at config 5
               with one bounce, 1024^2, from perturb(scale=0.05, seed=4): row 4
               by the oracle rule and bit for bit `render_vec_plain` (the
               image; 2 L planes, level 0's on the pixels the primary ray hit
               and level 1's where both levels hit, 0 elsewhere); row 6 given
               row 4's image of the truth a loss and gradient of exactly 0,
               and against autograd and its eager twin (every leaf within
               1e-2 of its scale, the env and mirror leaves included); row 5
               (by autograd of `render`) against autograd of the plain render
               and its twin for a unit normal cotangent, its mse gradient row
               6's bit for bit; one wrapper launch a call; three calls
               bit-identical. Each row's event time, device time and launches
               per call on the ``_levels`` entries, its plain version's time
               and its bound (`chrome_bounds`: level 0's culled walks, level
               1's sphere tests at the per-warp cull of
               `cull.bounce_candidates` and its culled shadow rays
               (`vec_bounce_counts`), the env's samples in `TEX_OPS`) beside
               the bound before the culls (every sphere at both levels); the
               most spheres a block takes with the env and the bounce.
 29. chrome_main - `render --config 10` (row 4 once); invert --config 10
               --perturb 0.2 --lr 2e-2 --iters 300 --seed 10 at 512^2 (the JAX
               package's scripts/config10_check.py; row 6 300 times, row 4
               twice): the loss falls, the mirror coefficients' RMS error ends
               below 1e-3, the observable texels' (|d sum(image) / d env| > 0
               at the truth, one autograd call of `render`) below 0.05 of its
               start, the others unchanged to the bit; at 48^2 the JAX test's
               run (tests/test_env.py:335-358: 60 steps, lr 2e-2, perturb
               0.25, seed 0; final loss < 5e-4, parameter error < 0.8 of its
               start, both groups moved by > 1e-3); 20 steps of
               optimize(render_fn=render) at 512^2 (lr 2e-2) and on config 5
               with one bounce at 1024^2 (lr 1e-2, the CLI's; row 4 21 times,
               row 5 20 in each; the loss falls); invert --config 5 --reflections 1 --iters 20 at 1024^2
               (row 6 20 times, row 4 twice; the loss falls).
 30. globes  - rows 4-6's textured instances (the ``_tex`` entries: object
               texel grids gathered from global memory, their gradient in a
               block texel row) on the 64 textured globes (config 5's 64
               spheres + ground, a 16 x 16 grid each, as the JAX package's
               scripts/vec_textured_tpu_check.py draws them: `globes_case`) at
               512^2 without and with one bounce, and on configs 7 and 8 with
               one bounce at 512^2, from perturb(scale=0.4, seed=0) of their
               texels, by the rules of phase 28 (row 4 by the oracle rule and
               bit for bit; rows 6 and 5 against autograd and their twins,
               every leaf within 1e-2 of its scale, the texels' gradient not
               0; three calls bit-identical; row 5's mse gradient row 6's bit
               for bit); each row's event and device time, launches per call,
               plain version's time and bound (`chrome_bounds`: the texel
               samples of both levels' textured winners in `TEX_OPS`, the
               texels read once and their gradient written once); the
               textured step's shared memory, Python's count against the C
               entries'.
 31. globes_main - invert --config 8|7 --reflections 1 --lr 3e-2 --perturb 0.4
               --iters 200 at 512^2 and 64^2 (row 6 200 times, row 4 twice,
               no other kernel; every loss falls; at 64^2 the JAX tests'
               criteria: a final loss below 1e-5 and the observable texels'
               RMS error below 0.3 / 0.25 of its start); 20 steps of
               `optimize_scan` (row 6 20 times, captured) and of
               optimize(render_fn=render) (rows 4 + 5, 20 times each) on the
               globes' texels at 512^2 without and with the bounce; each loss
               falls.
 32. soft_texture - rows 7, 8 and 9's texel instances (the ``_tex`` entries:
               each soft layer's textured winner's grid gathered from global
               memory, the environment's sample the composite's blend target at
               every pixel; the texel records into a block texel row) on the
               globes (softtex) and the sky field (softenv: `sky_field_case`)
               at 512^2, tau 0.05, and configs 7, 8 and 9 without its bounce at
               512^2, tau 0.08, from perturb(scale=0.4, seed=0) of their texels:
               row 7 by the oracle rule against its plain version; rows 9 and
               8 (by autograd of `render`) against autograd and their twins,
               every leaf within 1e-2 of its scale, the texels' gradient not 0;
               three calls of each bit-identical; row 9 against row 7's own
               image a loss and gradient of exactly 0; row 8's mse gradient row
               9's bit for bit; each row's event and device time, launches per
               call, plain version's time and bound (`soft_texture_bounds`: both
               layers' textured winners and the env's sample at every pixel in
               `TEX_OPS`, the texels read once and their gradient written
               once); the textured step's shared memory and prefix slots
               (pcap), Python's count against the C entries', with and without
               the grids, and the share of warps whose shadow walks overflow
               each (`prefix_overflow`).
 33. soft_texture_main - invert --config 7|8|9 --anneal 0.08,0.03,0.01,0 --lr
               3e-2 --perturb 0.4 --iters 50 (config 9 with --reflections 0) at
               512^2 and 64^2: row 7 three times, row 9 150, row 1 50 and row 2
               twice, no other kernel; every stage's loss falls and the
               observable texels' RMS error ends below its start;
               `optimize_annealed` on the globes' texels and on the sky field's
               env at 512^2 (taus 0.08, 0.03, 0.01, 0, 20 steps a stage: rows 7
               and 9 in the soft stages, row 6's texel or env instance in the
               polish); 20 steps of optimize(render_fn=render) on the globes at
               tau 0.05 (row 7 21 times, row 8 20); every loss falls.
 34. restarts - the restart proposals (`optim.propose_restart`) on config 2 at
               512^2 from perturb(scale=0.45, seed=2), r = 1..4, jitter 0.3,
               seed 7, each on the card against the port's CPU result from the
               same start and target: the five blind families bit for bit;
               `resid` (its attribution through row 2) the same suspect and
               peak pixel, every leaf within 1e-5 of its largest, the suspect
               compared only where its suspicion is more than 1e-4 (relative)
               from its neighbours' in the order (`guard_fired` counts the
               others); `resid` on config 5 at 512^2 (attribution through row
               4) the same way; a 3-restart chained `resid` multistart on
               config 2 at 64^2 (taus 0.08, 0.03, 0, 30 steps a stage):
               restart 0's final loss the plain `optimize_annealed`'s bit for
               bit, `optim._SCAN_CACHE` no longer than after that anneal (no
               capture beyond it), the start's leaves untouched, and row 7 6
               times, row 9 180, row 1 90, row 2 5 (3 rankings, 2
               attributions).
 35. restarts_main - invert --restarts on the card at full width: config 2's
               documented stall (--size 512 --iters 150 --perturb 0.45 --seed 2
               --anneal 0.08,0.03,0 --restarts 12 --restart-jitter 0.3
               --restart-proposal resid --restart-chain) must end below a hard
               loss of 1e-6 and a param RMS error of 1e-3 (row 7 24 times, row
               9 3600, row 1 1800, row 2 24: the target, 12 rankings, 11
               attributions); config 5 (--size 512 --anneal 0.08,0 --iters 20
               --perturb 0.03 --lr 2e-3 --restarts 3 --restart-proposal resid
               --restart-chain): row 7 3, row 9 60, row 6 60, row 4 6; every
               final finite, the best their minimum; each run's finals,
               restart 0's, the winner and its host-clock wall time, the
               captures included.
 36. bands   - rows 1-9 in row bands (each wrapper's ``row0`` / ``out_height``,
               the kernels' ``_band`` entries) at each family's full-width
               shape: config 2 at 512^2 (rows 1-3), config 5 at 1024^2 (rows
               4-6), config 5 at 512^2 and tau 0.08 (rows 7-9), from
               perturb(scale=0.05, seed=1), in 2 and in 4 bands: the forwards'
               bands put together equal the whole-image call to the bit (image,
               and the planes of rows 2 and 4); the sums of the bands' steps
               (the whole image's norm) and of the render backwards (a seeded
               normal cotangent) equal the whole-image call within 1e-4 of
               each leaf's scale (the worst printed); the last band of 4 held
               to its plain version at its row0 by phases 3, 4, 9, 11, 12 and
               16's rules (rows 2 and 4 bit for bit, row 7 by the oracle rule,
               the steps' loss within 1e-4 and leaves within 1e-2 of scale,
               the backwards within 1e-2); each row's device time for the
               whole image and summed over the bands of 2 and of 4.
 37. sharded_main - the sharded inverse render (`parallel`) on the one card:
               `invert --config 5 --size 1024 --iters 20 --sharded` (one rank
               over NCCL, the step a replayed CUDA graph holding the
               all-reduce) gives `invert`'s losses without the flag to the
               bit (row 6 20, row 4 1), and so does config 2 at 512^2 over 50
               steps (row 1 50, row 2 1), both runs' host-clock wall times
               printed, the captures included; `optimize_sharded_scan` with 2
               bands on the rank over 10 steps in each family, through the
               band step (rows 1, 6, 9: 20 launches) and through autograd of
               the band render (rows 2 + 3, 4 + 5, 7 + 8: 20 each), every
               loss finite and the last below the first; then
               `parallel.worker` as two ranks over gloo sharing the card
               (config 5 at 1024^2, 20 steps): the gathered image the one-rank
               render to the bit, the ranks' final scenes bit-identical, the
               loss falling, and its wall time (a gloo all-reduce goes through
               the host: it measures no NCCL scaling), then its batched step
               of two scenes, a scene a rank (its grad norm the batch's).
 38. spp4_texels - rows 1-8's textured, env and bounce instances at spp 4,
               512^2: rows 1-3 on configs 6, 7 and 9, rows 4-6 on config 10,
               config 8 with a bounce and the 64 textured globes (phases 24,
               26, 28 and 30's starts), by their rules (rows 2 and 4 bit for
               bit, each subsample's planes of each level on the pixels its
               ray hit at that level, 0 elsewhere; rows 1 and 6 zero against
               the forward's own image, against autograd and their twins; rows
               3 and 5 against autograd and their twins, row 3's mse gradient
               row 1's bit for bit, row 5's (autograd adds its four launches)
               row 6's within 1e-4 of scale; one launch a call, rows 4 and 5
               four); rows 7-8 on config 8 and the sky field at tau 0.08 by
               phase 32's (row 7 by the oracle rule, row 8 against autograd
               and its twin, four launches a call; row 9 refuses spp 4 by
               name). Rows 1, 3, 5, 6 and 8 against autograd of their plain
               versions within 1e-4 of each leaf's scale, or of its float64
               counterpart's, or, for a leaf that float32 does not determine
               so closely, no farther from the plain version than it is from
               its float64 counterpart (and within 1e-2); against their
               float32 twins within 1e-2, as at spp 1. Each row's event time, device time and launches per call
               on the ``_band`` entries, its plain version's time, its bound
               (each subsample's counts summed, `spp_work`), and the new
               instances' registers and spill bytes from ptxas.
 39. spp4_texels_main - invert --spp 4 at 512^2, 20 steps: --config 7 and 9
               (row 1 20, row 2 2), --config 6 (the same), --config 10 and
               --config 8 --reflections 1 (row 6 20, row 4 8), --config 8
               --anneal 0.08,0.03,0 (row 7 8 + 4 x 40 by autograd of the
               four-launch soft render, row 8 4 x 40, row 1 20, row 2 2);
               20 steps of optimize(render_fn=render) on configs 6, 7 and 9
               (rows 2 and 3 20 each) and on the 64 textured globes (rows 4
               and 5 80 each); every stage's loss falls, no other kernel
               launches.
 40. bounces - rows 1-6 at two and three bounce levels, 512^2: rows 1-3
               on config 6 (K = 2 and 3, spp 1 and 4) and config 9 (the env,
               K = 2), rows 4-6 on config 10 (K = 2 and 3; K = 2 at spp 4
               too) and config 8's globe with mirror coefficients 0.3 and its
               floor's 0.4 (`with_mirrors`, the ``_tex`` instances, K = 2), from the
               starts of phases mirror, texture, chrome and globes, by phase
               spp4_texels' rules (rows 2 and 4 bit for bit, each subsample's
               planes of each level on the pixels where it and every level
               above hit, 0 elsewhere; rows 1 and 6 zero against the
               forward's own image; rows 1, 3, 5 and 6 against autograd of
               their plain versions within 1e-4 of each leaf's scale, or of
               the float64 one's, or no farther than float32 from float64,
               and against their twins within 1e-2; at spp 1 row 3's or row
               5's mse gradient row 1's or row 6's bit for bit). Each row's
               times, plain times and bounds (`bounce_counts`,
               `vec_bounce_counts` and `texel_counts` count every bounce
               level as they count level 1), and the new instances' registers
               and spill bytes from ptxas.
 41. bounces_main - `render --config 6 --reflections 2` and `3` (row 2
               once); invert --reflections 2 at 512^2: --config 6 (150 steps,
               at 512^2 and 48^2: row 1 150, row 2 2, the mirror
               coefficients' RMS error below 1e-3), --config 9 (row 1 20),
               --config 10 and --config 8 (row 6 20, row 4 2), --config 6
               --spp 4 (row 1 20) and --config 10 --spp 4 (row 6 20, row 4
               8); 20 steps of optimize(render_fn=render) at K = 2 on config 6
               (rows 2 + 3) and config 10 (rows 4 + 5); every loss falls; and
               `render --config 6 --reflections 4` refused by name.
Then a `timing` line (each phase's wall seconds), the card's nvidia-smi
line, the {"kernels": [...]} line (each kernel
with its status as PERF.md's table of TPU kernels records it; `ms` is the
event time, and rows 1-5, 7 and 8 add `device_ms`, their kernels' device
time per call, and `launches_per_call`; the three forwards add
`launches_render_fn`, their launches in phase 17's run of their family,
beside `launches` on their CLI path; rows 7, 8 and 9 add `checker`, their
soft-checker instances' numbers from phases 20 and 21; rows 1-8 add
`spp4`, their numbers at spp 4 from phases 22 and 23: `ms`, `device_ms`,
`launches_per_call` of the profiler and `wrapper_launches_per_call` of the
counters, `max_abs_err`, `plain_ms`, `bound_ms`, and `launches` on the spp-4
CLI path); rows 1-3 add `mirror`, their numbers with a bounce level from
phases 24 and 25; rows 1-3 add `texture`, their textured instances'
numbers per config from phases 26 and 27; rows 4-6 add `chrome`, their env
and bounce instances' numbers per case from phases 28 and 29, and `globes`,
their textured instances' per case from phases 30 and 31; rows 7-9 add
`soft_texture`, their texel instances' per case from phases 32 and 33;
each kernel the restarts launch adds `restarts`, its launches in each run of
phases 34 and 35; every row adds `bands`, its case, its worst difference and
device times from phase 36 and its launches on the sharded paths of phase
37; rows 1-8 add `spp4_texels`, their numbers per case at spp 4 from phase
38 beside their launches on each run of phase 39; rows 1-6 add `bounces`, their numbers per
case at two and three bounce levels from phase 40 beside their launches on each run of phase
41), and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
# device_ms and time_ms (tools/kernel_timing.py) are imported by main, once
# it has found the repo beside this script.
PEAK_FP32_FLOPS = 67e12  # H100 SXM, non-tensor float32, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


PHASE_SECONDS: dict = {}  # each phase's wall seconds, printed before the card's line


def run_phase(name, fn, *args):
    import time

    t0 = time.perf_counter()
    try:
        return fn(*args)
    except BaseException as exc:
        emit(name, ok=False, error=f"{type(exc).__name__}: {exc}")
        raise
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 3)


# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", ok=True, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Function properties" in ln]


def phase_build():
    """Build the nine kernels as the port builds them, and alongside (all
    eleven nvcc processes at once) the small-scene render and step sources
    with nvcc's default FMA contraction, for phase fmad. Returns the
    contracted libraries. Records the eleven nvcc processes' CPU seconds
    and the cores they share: over the wall time, the cores the build kept
    busy."""
    import ctypes
    import os
    import resource
    import time

    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.kernels._build import (
        BUILD_DIR, NVCC_FLAGS, build_all, nvcc_path)

    t0 = time.perf_counter()
    ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f != "--fmad=false"]
    timed = (fused.FUSED_RENDER, fused.FUSED_STEP)
    procs = {k.name: subprocess.Popen(
        [nvcc_path(), *flags, "-o", str(BUILD_DIR / f"lib{k.name}_fmad.so"), str(k.source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in timed}
    try:
        seconds = build_all(_all_kernels())
        logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    contracted = {}
    for k in timed:
        if procs[k.name].returncode != 0:
            raise RuntimeError(f"nvcc (contracted) failed for {k.source.name}:\n{logs[k.name]}")
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{k.name}_fmad.so"))
        for fn, (argtypes, restype) in k.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        contracted[k.name] = lib
    ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    emit("build", ok=True, seconds=seconds, with_contracted_seconds=time.perf_counter() - t0,
         nvcc_cpu_seconds=ru1.ru_utime + ru1.ru_stime - ru0.ru_utime - ru0.ru_stime,
         cpu_cores=len(os.sched_getaffinity(0)),
         ptxas={k.name: _ptxas(k.build_log) for k in _all_kernels()},
         ptxas_contracted={name: _ptxas(log) for name, log in logs.items()})
    return contracted


def _all_kernels():
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    return fused.KERNELS + fused_vec.KERNELS + fused_vec_soft.KERNELS


def _hit_mask(scene, cfg):
    from reversible_raytracer_tpu_torch.ops import pipeline as pl

    o, d = pl.primary_rays(scene, cfg)
    return pl.trace_nearest(scene, o, d, cfg.shape)[1]


# Row 2's shapes: (label, config number or the spheres of config 5, size,
# visibility planes).
RENDER_CASES = (("config2_512", 2, 512, 1), ("config3_512", 3, 512, 2), ("config1_64", 1, 64, 0),
                ("24obj_512", 23, 512, 1))


def _render_case(num, size):
    from reversible_raytracer_tpu_torch.models import configs

    if num in configs.CONFIGS:
        return configs.CONFIGS[num](size=size, device="cuda")
    return configs.config5_many_spheres(size=size, n_spheres=num, device="cuda")


def phase_render():
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    rows = []
    for label, num, size, planes in RENDER_CASES:
        scene, _, cfg = _render_case(num, size)
        img_k, vis_k = fused.render_fused(scene, cfg)
        img_p, vis_p = fused.render_fused_plain(scene, cfg)
        torch.cuda.synchronize()
        if img_k.shape != img_p.shape or vis_k.shape != vis_p.shape or vis_k.shape[0] != planes:
            raise AssertionError(f"{label}: shapes {img_k.shape}/{vis_k.shape} "
                                 f"vs {img_p.shape}/{vis_p.shape}")
        if not torch.isfinite(img_k).all():
            raise AssertionError(f"{label}: non-finite pixels")
        err = (img_k - img_p).abs()
        hit = _hit_mask(scene, cfg)
        row = dict(shape=label, objects=scene.spheres.count + scene.rects.count, size=size,
                   planes=planes, frac_bad=float((err > 2e-3).float().mean()),
                   mean_err=float(err.mean()), max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(img_k, img_p)
                                      and torch.equal(vis_k[:, hit], vis_p[:, hit])),
                   vis_on_miss_zero=not bool(vis_k[:, ~hit].any()),
                   hit_share=float(hit.float().mean()))
        rows.append(row)
        if not (row["frac_bad"] < 1e-3 and row["mean_err"] < 1e-4 and row["bit_identical"]
                and row["vis_on_miss_zero"]):
            raise AssertionError(f"forward kernel disagrees with its plain version: {row}")
    emit("render", ok=True, rows=rows)
    return max(r["max_abs_err"] for r in rows if r["shape"] == "config2_512")


def _grad_errors(ga, gb):
    """Worst |a - b| / scale(a) per leaf (the rule of tests/test_fused_step.py)."""
    from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves

    out = {}
    for path, a, b in zip(leaf_paths(ga), tree_leaves(ga), tree_leaves(gb)):
        if a.numel():
            scale = max(float(a.abs().max()), 1e-6)
            out[path] = float((a - b).abs().max()) / scale
    return out


def phase_step():
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused

    scene, spec, cfg = configs.config2_four_spheres(size=512, device="cuda")
    start = configs.perturb(scene, spec, scale=0.1, seed=4)
    target = fused.render_fused_plain(scene, cfg)[0]
    runs = [fused.loss_grad_fused(start, cfg, target) for _ in range(3)]
    l_k, g_k = runs[0]
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    deterministic = all(torch.equal(flat[0], f) for f in flat[1:])
    l_p, g_p = fused.loss_grad_fused_plain(start, cfg, target)
    l_a, g_a = fused.loss_grad_adjoint_eager(start, cfg, target)
    torch.cuda.synchronize()
    report = {}
    for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
        rel = abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12)
        errs = _grad_errors(g_ref, g_k)
        worst = max(errs, key=errs.get)
        report[name] = dict(loss_rel=rel, worst_leaf=worst, worst_err=errs[worst])
        if not (rel <= 1e-4 and errs[worst] <= 1e-2):
            raise AssertionError(f"step kernel disagrees with {name}: {report[name]}")
    if not deterministic:
        raise AssertionError("step kernel: three calls are not bit-identical")
    max_abs = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel())
    emit("step", ok=True, loss=float(l_k), deterministic=deterministic, **report)
    return start, target, cfg, max_abs, g_p


def phase_main():
    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    png = out_dir / "final.png"
    for k in _all_kernels():
        k.launches = 0
    summary = cli.main(["invert", "--config", "2", "--size", "512", "--iters", "50",
                        "--perturb", "0.1", "--seed", "0", "--log-every", "10",
                        "--metrics", str(out_dir / "metrics.jsonl"), "-o", str(png)])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _all_kernels()}
    hist = summary["history"]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    ok = (launches["fused_render"] >= 2 and launches["fused_step"] == 50
          and all(n == 0 for name, n in launches.items() if name not in ("fused_render",
                                                                      "fused_step"))
          and math.isfinite(last) and last < first and png.exists()
          and math.isfinite(summary["param_err"]))
    emit("main", ok=ok, launches=launches, first_loss=first, final_loss=last,
         param_err=summary["param_err"], seconds=summary["seconds"],
         loop_ms_per_step=summary["seconds"] * 1e3 / 50, png_bytes=png.stat().st_size
         if png.exists() else 0)
    if not ok:
        raise AssertionError("main path did not run through both kernels or did not descend")
    return launches


def _launch(lib, fn, *args):
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def phase_fmad(contracted, step_inputs, g_plain):
    """Both kernels as built (--fmad=false) and with nvcc's default FMA
    contraction, timed on the same inputs in the order built, contracted,
    contracted, built; and how far the contracted build is from the plain
    version (reported, not held: the port ships the --fmad=false build)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    start, target, cfg = step_inputs
    geom = fused._geometry(start, cfg)
    flat = fused._cuda_flat(start, cfg)
    stream = torch.cuda.current_stream().cuda_stream
    H, W = cfg.height, cfg.width
    img = torch.empty((H, W, 3), device="cuda")
    vis = torch.empty((start.lights.count if cfg.shadows else 0, H, W), device="cuda")
    scratch = torch.empty((fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5]),),
                          device="cuda")
    out = torch.empty((1 + flat.numel(),), device="cuda")
    w = 1.0 / (H * W * 3)
    libs = {"built": (fused.FUSED_RENDER.lib(), fused.FUSED_STEP.lib()),
            "contracted": (contracted["fused_render"], contracted["fused_step"])}

    def render(which):
        return lambda: _launch(libs[which][0], "rrt_render", flat.data_ptr(), *geom,
                               img.data_ptr(), vis.data_ptr(), stream)

    def step(which):
        return lambda: _launch(libs[which][1], "rrt_step", flat.data_ptr(), *geom,
                               target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), stream)

    times = {}
    for kname, make in (("fused_render", render), ("fused_step", step)):
        runs = [(which, time_ms(make(which)))
                for which in ("built", "contracted", "contracted", "built")]
        times[kname] = {which: [t for wh, t in runs if wh == which]
                        for which in ("built", "contracted")}
    render("contracted")()
    step("contracted")()
    torch.cuda.synchronize()
    img_p, vis_p = fused.render_fused_plain(start, cfg)
    err = (img - img_p).abs()
    errs = _grad_errors(g_plain, fused.unflatten_scene(start, out[1:]))
    worst = max(errs, key=errs.get)
    emit("fmad", ok=True, size=H, ms=times,
         contracted_render=dict(frac_bad=float((err > 2e-3).float().mean()),
                                mean_err=float(err.mean()), max_abs_err=float(err.max()),
                                vis_diff_all=float((vis != vis_p).float().mean())),
         contracted_step=dict(worst_leaf=worst, worst_err=errs[worst]))


# ---------------------------------------------------------------------------
# Bounds: the operations and bytes that this run's work needs, counted from
# the code (csrc/render_common.cuh, csrc/fused_step.cu). Each add, subtract,
# multiply, divide, sqrt, rsqrt, floor, exp, log and tan counts one;
# comparisons, selects, min/max and negations count none. A value is counted
# once where it is needed once: what depends only on the scene (the camera
# basis, per-object and per-rect constants such as the rect normal and
# 1/|edge|^2, the sphere's |eye - c|^2 - r^2) once per launch, what depends
# only on a pixel's column or row once per column or row, and a pixel's own
# work once per pixel. The kernels recompute some of this per pixel, and the
# step's adjoint recomputes the forward of each lit light and of the winning
# object; the bound counts none of that. Each per-pixel term of the step's
# gradient counts one add into the sum over pixels.
OPS = dict(
    camera=43,  # basis, tan(fov/2), tan(fov/2) * aspect: once per launch
    sphere_const=13,  # eye - c, |eye - c|^2 - r^2, 1/r, 1/r^2, 2r: per sphere
    rect_const=40,  # normal, its unit and rsqrt^3, 1/|eu|^2, 1/|ev|^2, p0 - eye, num
    material_const=15,  # ambient * ka, color * ka, color * ambient (both colors)
    cam_chain=100,  # the step's camera_basis / normalize / tan chain, once
    line=7,  # per column (ax, sx, right sx) and per row (ay, sy, up sy)
    ray=15,  # fwd + right sx + up sy, its norm, rsqrt, d
    sphere_primary=9,  # b = (eye - c) . d, b^2 - c0, sqrt, -b - sqrt
    rect_primary=27,  # d . n, num / denom, o + d t - p0, a, b
    sphere_shadow=18,  # the same tests from the shadow origin
    rect_shadow=35,
    surf_sphere=25,  # hit point, p - c, n, checker parity
    surf_rect=18,  # facing, n, checker parity (a, b and p from the trace)
    miss_point=6,  # o + d BIG on a miss (its shadow rays fill the vis planes)
    so=6,  # shadow origin
    light=13,  # light_geometry of one light
    phong=34,  # diffuse + specular terms of one lit light
    resid=14,  # residual, squared error, 2 w residual, clip gradient
    adj_base=28,  # ambient adjoint, shadow-origin adjoint
    adj_camera=36,  # normalize adjoint of the ray, g_tan, g_dt sx, g_dt sy
    adj_light=98,  # one lit light's adjoint (forward values reused)
    adj_sphere=53, adj_rect=61,  # the winning object's adjoint
    sum_pixel=1, sum_miss=3, sum_hit=16,  # adds into the sums: sq; bg; ambient, eye, camera 10
    sum_sphere=14, sum_rect=19, sum_light=6,  # object fields; light position and color
    # A mirror bounce (a reflected ray's object tests cost a shadow ray's: its
    # origin is per pixel): the reflected direction d - 2 (d . n) n, the blend
    # col + m (col1 - col0), their adjoints (the mirror coefficient's (col1 -
    # col0) . gc, the cotangents m gc and (1 - m) gc; d and n from d1), and the
    # mirror field's add into the sums
    reflect=12, blend=9, adj_blend=15, adj_reflect=21, sum_mirror=1,
)


def work_counts(scene, cfg, cull=False, off=(0.0, 0.0)):
    """The work of one subsample, at the offset ``off`` from the pixel
    centres (`spp_work` sums the subsamples of spp 4): pixels by winner
    type, lit (pixel, light) pairs, and the shadow-ray
    sphere and rect tests the kernels run (the any-hit loop tests spheres,
    then rects, and stops at the first occluder), on hit pixels and on all
    pixels. With ``cull``, also the per-warp culls' work (csrc/cull.cuh, by
    the plain versions in ops/kernels/cull.py; a warp is 32 pixels of a row):
    the warps and their primary candidates, the (pixel, candidate) pairs
    the primary rays test; per light the warps with a hit lane, their shadow
    candidates, the (hit pixel, candidate) pairs inside them, and the
    sphere tests of the hit pixels' any-hit walks over the candidates until
    the first occluder."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import cull as cl
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import sphere_ts

    H, W = cfg.height, cfg.width
    dev = scene.device
    sp, rc = scene.spheres, scene.rects
    o, d = pl.primary_rays(scene, cfg, off)
    t_best = torch.full((H, W), pl.BIG, device=dev)
    kind = torch.zeros((H, W), dtype=torch.int32, device=dev)  # 0 miss, 1 sphere, 2 rect
    tests = [(1, lambda oo, dd, k=k: pl.intersect_sphere(oo, dd, sp.center[k], sp.radius[k]))
             for k in range(sp.count)]
    tests += [(2, lambda oo, dd, k=k: pl.intersect_rect(oo, dd, rc.origin[k], rc.edge_u[k],
                                                        rc.edge_v[k])[0])
              for k in range(rc.count)]
    for kk, test in tests:
        t = test(o, d)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        kind = torch.where(closer, kk, kind)
    hit = kind > 0
    _, _, at = pl.trace_nearest(scene, o, d, (H, W))
    so = pl.shadow_origin(o, d, t_best, (at["nx"], at["ny"], at["nz"]))
    shadow = {(kk, where): 0 for kk in (1, 2) for where in ("hit", "all")}
    lit = 0
    for li in range(scene.lights.count):
        ldir, dist = pl.light_geometry(scene.lights, li, so)
        done = torch.zeros((H, W), dtype=torch.bool, device=dev)
        for kk, test in tests:
            if cfg.shadows:
                shadow[kk, "hit"] += int((hit & ~done).sum())
                shadow[kk, "all"] += int((~done).sum())
            done = done | (test(so, ldir) < dist)
        lit += int((hit & ~done).sum()) if cfg.shadows else int(hit.sum())
    out = dict(height=H, width=W, pixels=H * W, sph=int((kind == 1).sum()),
               rect=int((kind == 2).sum()), hit=int(hit.sum()), lit=lit,
               shadow_sph_hit=shadow[1, "hit"], shadow_rect_hit=shadow[2, "hit"],
               shadow_sph_all=shadow[1, "all"], shadow_rect_all=shadow[2, "all"],
               n_sph=sp.count, n_rect=rc.count, lights=scene.lights.count)
    if not cull:
        return out
    with torch.no_grad():
        lanes = cl.runs(torch.ones((H, W), dtype=torch.bool, device=dev), False).sum(-1)
        n_p = cl.primary_candidates(sp, scene.camera.eye, d).sum(-1)  # (H, R)
        out.update(warps=lanes.numel(), prim_visits=int(n_p.sum()),
                   prim_pairs=int((n_p * lanes).sum()), prim_all=H * W * sp.count,
                   shadow_warps=0, shadow_visits=0, shadow_pairs=0, shadow_all=0,
                   shadow_sph_culled=0)
        if not cfg.shadows:
            return out
        hit_lanes = cl.runs(hit, False).sum(-1)
        for li in range(scene.lights.count):
            ldir, dist = pl.light_geometry(scene.lights, li, so)
            cand = cl.warp_candidates(sp, so, hit, scene.lights.position[li], 0.0)
            n_s = cand.sum(-1)
            keep = cl.per_pixel(cand, W)
            occ = (sphere_ts(sp, so, ldir) < dist[None]) & keep
            visited = torch.cumsum(keep, 0, dtype=torch.int16)
            first = occ.to(torch.uint8).argmax(0)
            tests_px = torch.where(occ.any(0), visited.gather(0, first[None])[0],
                                   visited[-1])
            out["shadow_warps"] += int((hit_lanes > 0).sum())
            out["shadow_visits"] += int(n_s.sum())
            out["shadow_pairs"] += int((n_s * hit_lanes).sum())
            out["shadow_all"] += int(hit.sum()) * sp.count
            out["shadow_sph_culled"] += int(tests_px[hit].sum())
            del occ, visited, keep
    return out


def _common_ops(c):
    """Per launch, per column and row, and the primary ray and its trace."""
    n_obj = c["n_sph"] + c["n_rect"]
    launch = (OPS["camera"] + c["n_sph"] * OPS["sphere_const"] + c["n_rect"] * OPS["rect_const"]
              + n_obj * OPS["material_const"])
    lines = (c["height"] + c["width"]) * OPS["line"]
    trace = c["n_sph"] * OPS["sphere_primary"] + c["n_rect"] * OPS["rect_primary"]
    return launch + lines + c["pixels"] * (OPS["ray"] + trace)


def render_ops(c, cull=False, misses=True):
    """A hard forward's operations: every object's primary test per pixel
    and, as rows 2 and 4 shaded before their redesigns, the shadow rays of
    every pixel (a miss's from the BIG sentinel); ``misses=False``: as row 2
    shades since its redesign, no shading and no shadow rays where the ray
    hits nothing; ``cull``: row 4's per-warp culls (`_cull_ops` over the
    counts of `work_counts(..., cull=True)`) and no shadow rays on a miss."""
    miss = c["pixels"] - c["hit"]
    shade = c["sph"] * OPS["surf_sphere"] + c["rect"] * OPS["surf_rect"] + c["lit"] * OPS["phong"]
    hit_shadows = c["hit"] * (OPS["so"] + c["lights"] * OPS["light"]) + shade
    if cull:
        culled, _ = _cull_ops(c)
        return (_common_ops(c) - c["pixels"] * c["n_sph"] * OPS["sphere_primary"] + culled
                + hit_shadows + c["shadow_rect_hit"] * OPS["rect_shadow"])
    if not misses:
        return (_common_ops(c) + hit_shadows + c["shadow_sph_hit"] * OPS["sphere_shadow"]
                + c["shadow_rect_hit"] * OPS["rect_shadow"])
    return (_common_ops(c) + c["pixels"] * (OPS["so"] + c["lights"] * OPS["light"])
            + miss * OPS["miss_point"] + shade
            + c["shadow_sph_all"] * OPS["sphere_shadow"]
            + c["shadow_rect_all"] * OPS["rect_shadow"])


# The per-warp culls of rows 4-6 (csrc/cull.cuh), counted as the rest of
# OPS at what the cheapest known algorithm spends: per sphere once, its
# offset from the eye, distance, widened radius r' and sqrt(D^2 - r'^2); per
# warp the cone (the axis from its lanes' directions, its cosine and sine);
# per (warp, sphere) the cone test (a . (c - eye) against cos theta
# sqrt(D^2 - r'^2) - sin theta r'); per (warp, sphere, light) with a hit
# lane the segment test (SOFT_OPS' warp_test); then per (pixel, candidate)
# the primary sphere test, and per hit pixel the shadow sphere tests over
# the candidates until the first occluder.
CULL_OPS = dict(cone_sphere=12, cone_warp=30, cone_test=8)


def _cull_ops(c, shadows=True):
    """The culled walks' operations, and the full walks' they replace."""
    culled = (c["n_sph"] * CULL_OPS["cone_sphere"]
              + c["warps"] * (CULL_OPS["cone_warp"] + c["n_sph"] * CULL_OPS["cone_test"])
              + c["prim_pairs"] * OPS["sphere_primary"])
    full = c["pixels"] * c["n_sph"] * OPS["sphere_primary"]
    if shadows:
        culled += (c["shadow_warps"] * c["n_sph"] * SOFT_OPS["warp_test"]
                   + c["shadow_sph_culled"] * OPS["sphere_shadow"])
        full += c["shadow_sph_hit"] * OPS["sphere_shadow"]
    return culled, full


def step_ops(c, cull=False):
    """The step's operations; ``cull`` counts rows 5-6's per-warp culls in
    place of the full walks (the counts of `work_counts(..., cull=True)`)."""
    culled, full = _cull_ops(c) if cull else (0, 0)
    miss = c["pixels"] - c["hit"]
    per_hit = (OPS["so"] + c["lights"] * OPS["light"] + OPS["adj_base"] + OPS["adj_camera"]
               + OPS["sum_hit"])
    return (_common_ops(c) + OPS["cam_chain"] + culled - full
            + c["pixels"] * (OPS["resid"] + OPS["sum_pixel"]) + miss * OPS["sum_miss"]
            + c["hit"] * per_hit
            + c["sph"] * (OPS["surf_sphere"] + OPS["adj_sphere"] + OPS["sum_sphere"])
            + c["rect"] * (OPS["surf_rect"] + OPS["adj_rect"] + OPS["sum_rect"])
            + c["lit"] * (OPS["phong"] + OPS["adj_light"] + OPS["sum_light"])
            + c["shadow_sph_hit"] * OPS["sphere_shadow"]
            + c["shadow_rect_hit"] * OPS["rect_shadow"])


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Counts of `work_counts` / `soft_work_counts` that depend on the scene or the
# image's size alone, not on how many subsamples it takes.
SCENE_KEYS = ("height", "width", "n_sph", "n_rect", "lights", "checker")


def spp_work(count_fn, scene, cfg):
    """``count_fn(scene, cfg, off=...)``'s counts at ``cfg.spp``: each
    subsample's pixel work, counted at its offsets, summed; the scene's work
    once (at spp 4 the bound counts each pixel four times, the scene once)."""
    import dataclasses

    from reversible_raytracer_tpu_torch.ops.pipeline import SPP_OFFSETS

    cfg1, out = dataclasses.replace(cfg, spp=1), None
    for off in SPP_OFFSETS[cfg.spp]:
        c = count_fn(scene, cfg1, off=off)
        if out is None:
            out = dict(c)
        else:
            for k, v in c.items():
                if k not in SCENE_KEYS:
                    out[k] += v
    return out


def _render_shape_times(num, size):
    """Row 2 at another shape: its event and device time, and its bound."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    scene, _, cfg = _render_case(num, size)
    flat = fused._cuda_flat(scene, cfg)
    geom = fused._geometry(scene, cfg)
    img = torch.empty((size, size, 3), device="cuda")
    vis = torch.empty((scene.lights.count, size, size), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        fused.FUSED_RENDER.call("rrt_render", flat.data_ptr(), *geom, img.data_ptr(),
                                vis.data_ptr(), stream)

    nbytes = 4 * (flat.numel() + size * size * (3 + vis.shape[0]))
    return dict(ms=time_ms(call), device=device_ms(call),
                bound=bound(render_ops(work_counts(scene, cfg), misses=False), nbytes))


def phase_times(step_inputs, launches, render_err, step_err):
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    start, target, cfg = step_inputs
    scene = start
    S = fused.flatten_scene(scene).numel()
    geom = fused._geometry(scene, cfg)
    flat = fused._cuda_flat(scene, cfg)
    stream = torch.cuda.current_stream().cuda_stream
    H, W = cfg.height, cfg.width
    n_vis = scene.lights.count if cfg.shadows else 0
    img = torch.empty((H, W, 3), device="cuda")
    vis = torch.empty((n_vis, H, W), device="cuda")
    scratch = torch.empty((fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5]),),
                          device="cuda")
    out = torch.empty((1 + S,), device="cuda")
    w = 1.0 / (H * W * 3)
    saved = {k.name: k.launches for k in fused.KERNELS}

    render = lambda: fused.FUSED_RENDER.call(  # noqa: E731
        "rrt_render", flat.data_ptr(), *geom, img.data_ptr(), vis.data_ptr(), stream)
    step = lambda: fused.FUSED_STEP.call(  # noqa: E731
        "rrt_step", flat.data_ptr(), *geom, target.data_ptr(), w, scratch.data_ptr(),
        out.data_ptr(), stream)
    render_ms, step_ms = time_ms(render), time_ms(step)
    device = {"fused_render": device_ms(render), "fused_step": device_ms(step)}
    if device["fused_step"]["launches"] != 1:  # one cooperative launch a call
        raise AssertionError(f"row 1 did not make one launch a call: {device['fused_step']}")
    render_plain_ms = time_ms(lambda: fused.render_fused_plain(scene, cfg))
    step_plain_ms = time_ms(lambda: fused.loss_grad_fused_plain(scene, cfg, target))
    render_shapes = {label: _render_shape_times(num, size) for label, num, size, _ in RENDER_CASES
                     if label in ("config3_512", "24obj_512")}
    for k in fused.KERNELS:
        k.launches = saved[k.name]

    c = work_counts(scene, cfg)
    r_bound, r_by = bound(render_ops(c, misses=False), 4 * (S + H * W * (3 + n_vis)))
    s_bound, s_by = bound(step_ops(c), 4 * (S + H * W * 3 + 1 + S))
    kernels = [
        dict(name="fused_step", route="cuda",
             source="reversible_raytracer_tpu_torch/ops/kernels/csrc/fused_step.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused.py:394",
             launches=launches["fused_step"], max_abs_err=step_err, ms=step_ms,
             plain_ms=step_plain_ms, bound_ms=s_bound, bound_by=s_by, library_ms=None,
             device_ms=device["fused_step"]["ms"],
             launches_per_call=device["fused_step"]["launches"]),
        dict(name="fused_render", route="cuda",
             source="reversible_raytracer_tpu_torch/ops/kernels/csrc/fused_render.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused.py:224",
             launches=launches["fused_render"], max_abs_err=render_err, ms=render_ms,
             plain_ms=render_plain_ms, bound_ms=r_bound, bound_by=r_by, library_ms=None,
             device_ms=device["fused_render"]["ms"],
             launches_per_call=device["fused_render"]["launches"]),
    ]
    emit("times", ok=True, size=H, work=c, render_ops=render_ops(c, misses=False),
         step_ops=step_ops(c), step_rays_per_s=H * W / (step_ms * 1e-3),
         ms={"fused_render": render_ms, "fused_step": step_ms}, device=device,
         render_shapes=render_shapes)
    return kernels



# ---------------------------------------------------------------------------
# The object-chunked kernels (scenes of more than 24 objects)
# ---------------------------------------------------------------------------

# bench.py:717-747: config 5 as BASELINE.json defines it (64 spheres +
# ground, 1024^2) and the 513-object shape (512 spheres + ground, 512^2).
VEC_SHAPES = (("config5_1024", 64, 1024), ("513obj_512", 512, 512))


def _vec_case(n_spheres, size):
    from reversible_raytracer_tpu_torch.models import configs

    scene, spec, cfg = configs.config5_many_spheres(size=size, n_spheres=n_spheres,
                                                    device="cuda")
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    return scene, start, cfg


def _vec_hit_mask(scene, cfg):
    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec

    o, d = pl.primary_rays(scene, cfg)
    return nearest_vec(scene, o, d)[1] >= 0


def phase_vec_render():
    """Row 4 against render_vec_plain; returns the largest image difference
    at config 5 and the targets (plain renders of the true scenes)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec

    rows, targets = [], {}
    for label, n_spheres, size in VEC_SHAPES:
        scene, _, cfg = _vec_case(n_spheres, size)
        img_k, vis_k = fused_vec.render_vec(scene, cfg)
        img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
        torch.cuda.synchronize()
        if img_k.shape != img_p.shape or vis_k.shape != vis_p.shape or vis_k.shape[0] != 1:
            raise AssertionError(f"{label}: shapes {img_k.shape}/{vis_k.shape} "
                                 f"vs {img_p.shape}/{vis_p.shape}")
        if not torch.isfinite(img_k).all():
            raise AssertionError(f"{label}: non-finite pixels")
        err = (img_k - img_p).abs()
        hit = _vec_hit_mask(scene, cfg)
        row = dict(shape=label, objects=n_spheres + 1, size=size,
                   frac_bad=float((err > 2e-3).float().mean()), mean_err=float(err.mean()),
                   max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(img_k, img_p) and
                                      torch.equal(vis_k[:, hit], vis_p[:, hit])),
                   vis_diff_hit=float((vis_k != vis_p)[:, hit].float().mean()),
                   vis_on_miss_zero=not bool(vis_k[:, ~hit].any()),
                   cull=cull_counters(work_counts(scene, cfg, cull=True)))
        rows.append(row)
        if not (row["frac_bad"] < 1e-3 and row["mean_err"] < 1e-4 and row["vis_diff_hit"] < 1e-3
                and row["bit_identical"] and row["vis_on_miss_zero"]):
            raise AssertionError(f"vec forward kernel disagrees with its plain version: {row}")
        targets[label] = img_p
    emit("vec_render", ok=True, rows=rows)
    return rows[0]["max_abs_err"], targets


# The most spheres a block of rows 5-6 took with config 5's rect and light
# on the H100 (232,448 bytes of shared memory a block) before the per-warp
# culls, and a block of rows 4 and 7: the layouts with the culls must take
# at least as many.
VEC_MOST_SPHERES_BEFORE = 1520
FWD_MOST_SPHERES_BEFORE = 3392


def phase_vec_step(targets):
    """Row 6 against autograd and the eager adjoint, two calls bit for bit,
    and against row 4's own image of the same scene (the true one, and
    perturb seeds 0-2) a loss and gradient of exactly 0; returns the largest
    gradient difference from autograd at config 5."""
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    rows, max_abs = [], None
    for label, n_spheres, size in VEC_SHAPES:
        scene, start, cfg = _vec_case(n_spheres, size)
        spec = configs.config5_many_spheres(size=size, n_spheres=n_spheres, device="cuda")[1]
        zero = {}
        for seed in (None, 0, 1, 2):
            sc = scene if seed is None else configs.perturb(scene, spec, scale=0.05, seed=seed)
            l_0, g_0 = fused_vec.loss_grad_vec(sc, cfg, fused_vec.render_vec(sc, cfg)[0].detach())
            zero["true" if seed is None else f"seed{seed}"] = bool(
                float(l_0) == 0.0 and not fused.flatten_scene(g_0).any())
        target = targets[label]
        l_k, g_k = fused_vec.loss_grad_vec(start, cfg, target)
        l_k2, g_k2 = fused_vec.loss_grad_vec(start, cfg, target)
        torch.cuda.reset_peak_memory_stats()
        l_p, g_p = fused_vec.loss_grad_vec_plain(start, cfg, target)
        plain_peak = torch.cuda.max_memory_allocated()
        l_a, g_a = fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target)
        torch.cuda.synchronize()
        same = bool(torch.equal(torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                                torch.cat([l_k2.reshape(1), fused.flatten_scene(g_k2)])))
        row = dict(shape=label, loss=float(l_k), deterministic=same,
                   plain_peak_gb=plain_peak / 1e9, zero_residual_exact=zero)
        for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
            rel = abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12)
            errs = _grad_errors(g_ref, g_k)
            worst = max(errs, key=errs.get)
            row[name] = dict(loss_rel=rel, worst_leaf=worst, worst_err=errs[worst])
            if not (rel <= 1e-4 and errs[worst] <= 1e-2):
                raise AssertionError(f"vec step kernel disagrees with {name}: {row}")
        if not same:
            raise AssertionError(f"vec step kernel is not bit-identical from call to call: {row}")
        if not all(zero.values()):
            raise AssertionError(f"vec step kernel's forward is not the vec forward's: {row}")
        rows.append(row)
        if max_abs is None:
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel())
    most, most_fwd = fused_vec.most_spheres(), fused_vec.most_render_spheres()
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448 and (
            most < VEC_MOST_SPHERES_BEFORE or most_fwd < FWD_MOST_SPHERES_BEFORE):
        raise AssertionError(f"a block of the vec step takes {most} spheres and one of the vec "
                             f"forward {most_fwd}, fewer than the {VEC_MOST_SPHERES_BEFORE} and "
                             f"{FWD_MOST_SPHERES_BEFORE} they took before the culls")
    emit("vec_step", ok=True, rows=rows, most_spheres=most,
         most_spheres_before=VEC_MOST_SPHERES_BEFORE, most_render_spheres=most_fwd,
         most_render_spheres_before=FWD_MOST_SPHERES_BEFORE)
    return max_abs


def phase_vec_main():
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    png = out_dir / "final_config5.png"
    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    summary = cli.main(["invert", "--config", "5", "--size", "1024", "--iters", "20",
                        "--seed", "0", "--log-every", "5",
                        "--metrics", str(out_dir / "metrics_config5.jsonl"), "-o", str(png)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _all_kernels()}
    hist = summary["history"]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    ok = (launches["fused_vec_render"] >= 2 and launches["fused_vec_step"] == 20
          and all(n == 0 for name, n in launches.items() if name not in ("fused_vec_render",
                                                                      "fused_vec_step"))
          and math.isfinite(last) and last < first and png.exists()
          and math.isfinite(summary["param_err"]))
    emit("vec_main", ok=ok, launches=launches, first_loss=first, final_loss=last,
         param_err=summary["param_err"], loop_seconds=summary["seconds"], wall_seconds=wall,
         loop_ms_per_step=summary["seconds"] * 1e3 / 20,
         png_bytes=png.stat().st_size if png.exists() else 0)
    if not ok:
        raise AssertionError("config-5 main path did not run through the vec kernels only, "
                             "or did not descend")
    return launches


def vec_step_bytes(pixels, Sg, ns_pad, nr_pad, planes=0):
    """The bytes the function needs: inputs read once (globals, rows, the
    target or the image cotangent of the image's ``pixels``, ``planes``
    visibility planes of as many), outputs written once (loss, gradients).
    The per-block partial rows are the kernels' own scratch, not counted.
    ``pixels`` is the image's H*W at any spp: the subsamples read no more."""
    rows = Sg + ns_pad * 17 + nr_pad * 22
    return 4 * (rows + (3 + planes) * pixels + 1 + rows)


def cull_counters(c):
    """Rows 5-6's cull counters from `work_counts(..., cull=True)`: candidate
    visits per warp walk, and the (pixel, sphere) pairs the culls keep
    against all pairs, for the primary rays and the step's shadow rays."""
    return dict(primary_visits_per_walk=c["prim_visits"] / max(c["warps"], 1),
                primary_kept_pairs=c["prim_pairs"], primary_all_pairs=c["prim_all"],
                shadow_visits_per_walk=c["shadow_visits"] / max(c["shadow_warps"], 1),
                shadow_kept_pairs=c["shadow_pairs"], shadow_all_pairs=c["shadow_all"],
                shadow_sphere_tests=c["shadow_sph_culled"],
                shadow_sphere_tests_uncull=c["shadow_sph_hit"])


def phase_vec_times():
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    stream = torch.cuda.current_stream().cuda_stream
    saved = {k.name: k.launches for k in _all_kernels()}
    rows = {}
    for label, n_spheres, size in VEC_SHAPES:
        scene, start, cfg = _vec_case(n_spheres, size)
        H, W = cfg.height, cfg.width
        target = fused_vec.render_vec_plain(scene, cfg)[0]
        glob, sph, rct = fused_vec._cuda_inputs(start, cfg)
        geom = fused_vec._geometry(start, cfg)
        img = torch.empty((H, W, 3), device="cuda")
        vis = torch.empty((1, H, W), device="cuda")
        scratch = torch.empty((fused_vec.VEC_STEP.lib().rrt_vec_step_scratch_floats(
            *geom[2:7]),), device="cuda")
        out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device="cuda")
        w = 1.0 / (H * W * 3)
        render = lambda: fused_vec.VEC_RENDER.call(  # noqa: E731
            "rrt_vec_render", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom,
            img.data_ptr(), vis.data_ptr(), stream)
        render_ms, render_device = time_ms(render), device_ms(render)
        step_ms = time_ms(lambda: fused_vec.VEC_STEP.call(
            "rrt_vec_step", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom,
            target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), stream))
        render_plain_ms = time_ms(lambda: fused_vec.render_vec_plain(start, cfg), reps=10)
        step_plain_ms = time_ms(lambda: fused_vec.loss_grad_vec_plain(start, cfg, target),
                                reps=10)
        c = work_counts(start, cfg, cull=True)
        Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
        in_rows = 4 * (Sg + ns_pad * 17 + nr_pad * 22)
        s_bytes = vec_step_bytes(H * W, Sg, ns_pad, nr_pad)
        r_bytes = in_rows + 4 * H * W * 4
        s_bound = bound(step_ops(c, cull=True), s_bytes)
        rows[label] = dict(render_ms=render_ms, step_ms=step_ms, render_plain_ms=render_plain_ms,
                           step_plain_ms=step_plain_ms,
                           render_bound=bound(render_ops(c, cull=True), r_bytes),
                           render_bound_uncull=bound(render_ops(c), r_bytes),
                           render_device=render_device, step_bound=s_bound,
                           step_bound_uncull=bound(step_ops(c), s_bytes),
                           render_ops=render_ops(c, cull=True),
                           render_ops_uncull=render_ops(c), step_ops=step_ops(c, cull=True),
                           step_ops_uncull=step_ops(c), step_bytes=s_bytes,
                           cull=cull_counters(c), work=c,
                           step_rays_per_s=H * W / (step_ms * 1e-3))
    for k in _all_kernels():
        k.launches = saved[k.name]
    emit("vec_times", ok=True, rows=rows)
    return rows

# ---------------------------------------------------------------------------
# The soft-visibility kernels (soft_tau > 0: the annealed inversion)
# ---------------------------------------------------------------------------

# (label, spheres, size, tau): config 5 at the anneal's soft size and at its
# published size, at the first and last soft stages' taus, and bench.py's
# 513-object shape.
SOFT_CASES = (("config5_512_t0.08", 64, 512, 0.08), ("config5_512_t0.01", 64, 512, 0.01),
              ("config5_1024_t0.08", 64, 1024, 0.08), ("config5_1024_t0.01", 64, 1024, 0.01),
              ("513obj_512_t0.08", 512, 512, 0.08))
SOFT_TIMED = ("config5_512_t0.08", "config5_1024_t0.08", "513obj_512_t0.08")


def _soft_case(n_spheres, size, tau):
    import dataclasses

    scene, start, cfg = _vec_case(n_spheres, size)
    return scene, start, dataclasses.replace(cfg, soft_tau=tau)


def phase_soft_render():
    """Row 7 against render_vec_soft_plain; returns the largest image
    difference at config 5, 512^2, tau 0.08 (the anneal's first stage)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft

    rows = []
    for label, n_spheres, size, tau in SOFT_CASES:
        scene, _, cfg = _soft_case(n_spheres, size, tau)
        img_k = fused_vec_soft.render_vec_soft(scene, cfg)
        img_p = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        torch.cuda.synchronize()
        if img_k.shape != img_p.shape or not torch.isfinite(img_k).all():
            raise AssertionError(f"{label}: shape {tuple(img_k.shape)} or non-finite pixels")
        err = (img_k - img_p).abs()
        row = dict(case=label, frac_bad=float((err > 2e-3).float().mean()),
                   mean_err=float(err.mean()), max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(img_k, img_p)),
                   cull=soft_cull_counters(soft_work_counts(scene, cfg)))
        rows.append(row)
        if not (row["frac_bad"] < 1e-3 and row["mean_err"] < 1e-4):
            raise AssertionError(f"soft forward kernel disagrees with its plain version: {row}")
    emit("soft_render", ok=True, rows=rows)
    return rows[0]["max_abs_err"]


def soft_cull_counters(c):
    """Row 7's cull counters from `soft_work_counts`: candidate visits per
    warp walk and the (pixel, sphere) pairs kept against all pairs, for the
    ranking's cone and for the shadow products (layer-and-light walks with
    a candidate; live pairs inside the candidates, and those the per-pixel
    rule keeps)."""
    return dict(primary_visits_per_walk=c["prim_visits"] / max(c["warps"], 1),
                primary_kept_pairs=c["prim_pairs"], primary_all_pairs=c["prim_all"],
                shadow_visits_per_walk=c["warp_visits"] / max(c["walks"], 1),
                shadow_kept_pairs=c["candidate_pairs"], shadow_rule_kept_pairs=c["shadow_kept"],
                shadow_all_pairs=c["shadow_tests"])


def phase_soft_step():
    """Row 9 against autograd and the eager adjoint, and two calls bit for
    bit; returns the largest gradient difference from autograd at config 5,
    512^2, tau 0.08."""
    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    rows, max_abs = [], None
    for label, n_spheres, size, tau in SOFT_CASES:
        scene, start, cfg = _soft_case(n_spheres, size, tau)
        target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        l_k, g_k = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
        l_k2, g_k2 = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
        torch.cuda.reset_peak_memory_stats()
        l_p, g_p = fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target)
        plain_peak = torch.cuda.max_memory_allocated()
        l_a, g_a = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
        torch.cuda.synchronize()
        same = bool(torch.equal(torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                                torch.cat([l_k2.reshape(1), fused.flatten_scene(g_k2)])))
        row = dict(case=label, loss=float(l_k), deterministic=same,
                   plain_peak_gb=plain_peak / 1e9)
        for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
            rel = abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12)
            errs = _grad_errors(g_ref, g_k)
            worst = max(errs, key=errs.get)
            row[name] = dict(loss_rel=rel, worst_leaf=worst, worst_err=errs[worst])
        # the true scene against the forward kernel's image of it
        img = fused_vec_soft.render_vec_soft(scene, cfg)
        l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg, img)
        torch.cuda.synchronize()
        row["zero_residual_exact"] = bool(float(l_0) == 0.0
                                          and not fused.flatten_scene(g_0).any())
        rows.append(row)
        for name in ("autograd", "adjoint_eager"):
            if not (row[name]["loss_rel"] <= 1e-4 and row[name]["worst_err"] <= 1e-2):
                raise AssertionError(f"soft step kernel disagrees with {name}: {row}")
        if not same:
            raise AssertionError(f"soft step kernel is not bit-identical from call to call: {row}")
        if not row["zero_residual_exact"]:
            raise AssertionError(f"soft step kernel's forward is not the soft forward's: {row}")
        if max_abs is None:
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel())
    most_fwd = fused_vec_soft.most_render_spheres()
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448 and most_fwd < FWD_MOST_SPHERES_BEFORE:
        raise AssertionError(f"a block of the soft forward takes {most_fwd} spheres, fewer than "
                             f"the {FWD_MOST_SPHERES_BEFORE} it took before the culls")
    emit("soft_step", ok=True, rows=rows, most_spheres=fused_vec_soft.most_spheres(),
         most_render_spheres=most_fwd, most_render_spheres_before=FWD_MOST_SPHERES_BEFORE)
    return max_abs


ANNEAL_TAUS = (0.08, 0.03, 0.01, 0.0)
ANNEAL_ITERS = 20


def phase_anneal_main():
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    png = out_dir / "final_anneal.png"
    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    summary = cli.main(["invert", "--config", "5", "--size", "1024", "--anneal",
                        ",".join(str(t) for t in ANNEAL_TAUS), "--anneal-size", "512",
                        "--lr", "2e-3", "--perturb", "0.03", "--iters", str(ANNEAL_ITERS),
                        "--seed", "0", "--metrics", str(out_dir / "metrics_anneal.jsonl"),
                        "-o", str(png)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _all_kernels()}
    la = summary["losses"]
    stages = [la[i * ANNEAL_ITERS:(i + 1) * ANNEAL_ITERS] for i in range(len(ANNEAL_TAUS))]
    soft_fall = [st[-1] < st[0] for st, tau in zip(stages, ANNEAL_TAUS) if tau > 0]
    expect = {"fused_vec_soft_render": 3, "fused_vec_soft_step": 3 * ANNEAL_ITERS,
              "fused_vec_step": ANNEAL_ITERS, "fused_render": 0, "fused_step": 0}
    ok = (all(launches[name] == n for name, n in expect.items())
          and launches["fused_vec_render"] >= 2 and all(soft_fall)
          and all(math.isfinite(x) for x in la) and png.exists()
          and summary["param_err"] < summary["start_param_err"])
    emit("anneal_main", ok=ok, launches=launches, expected=expect,
         stage_first_last=[[st[0], st[-1]] for st in stages], soft_stages_fall=soft_fall,
         start_param_err=summary["start_param_err"], param_err=summary["param_err"],
         loop_seconds=summary["seconds"], wall_seconds=wall,
         loop_ms_per_step=summary["seconds"] * 1e3 / len(la),
         png_bytes=png.stat().st_size if png.exists() else 0)
    if not ok:
        raise AssertionError("the annealed path did not run through the expected kernels, a "
                             "soft stage did not descend, or the parameters did not improve")
    return launches


# Soft terms, counted as the rest of OPS (csrc/soft_common.cuh,
# csrc/soft_step.cuh): the sigmoid of a ranked near miss; one soft shadow
# test (a sphere's coverage of a shadow ray and its factor in the product),
# counted for every sphere, live layer and light in the forward; its
# adjoint; the per-pixel cull test of a (pixel, sphere) pair the step drops
# (oc, b, |oc|^2 - r^2, disc); the per-warp test of one sphere against a
# warp's ball of shadow origins (c - c_w, its projection on the segment to
# the light, clamped, the offset and its square against (R + rho)^2); a
# live sphere layer's coverage and its adjoint; the composite and its
# adjoint per pixel. The step's shadow terms are counted with the cull at
# what the cheapest known algorithm spends: per (warp, sphere, layer,
# light) with a live lane the warp test, per live lane of a warp's
# candidate the pixel test, and a kept pair at its soft test and adjoint;
# and, as before the cull, every pair at its soft test and each pair whose
# coverage is not gated to zero at its adjoint. The soft checker (checker_tau
# > 0) adds per live layer pixel its blend (per axis x s, mod, |.|, the
# squash; the product, the parity, u, c1 + u (c2 - c1)) and in the step its
# adjoint (the colours' split, g_u, each axis's cotangent from the others'
# product, into p - c and the scale; a rect's (a, b) again and their
# normalizations into rel, the edges and t) and two more fields summed.
SOFT_OPS = dict(rank_sigmoid=4, shadow_soft=26, adj_shadow=42, shadow_cull=16, warp_test=25,
                layer_alpha=4, adj_alpha=12, composite=18, adj_composite=30,
                checker_sphere=53, checker_rect=39, adj_checker_sphere=56,
                adj_checker_rect=125, sum_checker=2)


def soft_work_counts(scene, cfg, off=(0.0, 0.0)):
    """What the soft kernels' work depends on in this run's data, for the
    subsample at the offset ``off`` from the pixel centres: live
    layers by winner type, sphere-ray pairs that rank by their sigmoid, and
    the soft shadow tests, the ones whose coverage is not gated to zero and
    the ones the cull keeps, over both layers and every light; by
    `cull.warp_candidates`, the warps' sphere tests (a warp with a
    live lane tests every sphere), their candidate visits (each a walk step
    of 32 lanes), the live (pixel, sphere) pairs inside those candidates,
    and the layer-and-light walks with a candidate; by
    `cull.primary_candidates` at tau (row 7's ranking), the warps, their
    candidate visits, the (pixel, candidate) pairs the ranking tests, and
    those of them that rank by their sigmoid; and whether the soft checker
    is on (``checker_tau > 0``)."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops import pipeline_vec as pv
    from reversible_raytracer_tpu_torch.ops.kernels import cull
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft as fvs

    with torch.no_grad():
        H, W = cfg.height, cfg.width
        tau = cfg.soft_tau
        sp, rc = scene.spheres, scene.rects
        N, M, L = sp.count, rc.count, scene.lights.count
        o, d = pl.primary_rays(scene, cfg, off)
        c, r = pv.sphere_axis(sp)
        oc = pl.vm.vsub(pv._lead(o), c)
        b = pl.vm.vdot(oc, pv._lead(d))
        disc = b * b - (pl.vm.vdot(oc, oc) - r * r)
        t = -b - pl.vm.safe_sqrt(disc)
        sigm = (~((disc > 0) & (t > pl.T_EPS))) & (-b > pl.T_EPS)
        n_p = cull.primary_candidates(sp, scene.camera.eye, d, tau)  # (H, R, N)
        keep = cull.per_pixel(n_p, W)
        lanes_p = cull.runs(torch.ones((H, W), dtype=torch.bool, device=scene.device),
                            False).sum(-1)
        prim = dict(warps=lanes_p.numel(), prim_visits=int(n_p.sum()),
                    prim_pairs=int((n_p.sum(-1) * lanes_p).sum()), prim_all=H * W * N,
                    ranked_sigmoid_cull=int((sigm & keep).sum()))
        ranked = int(sigm.sum())
        del oc, b, disc, t, sigm, keep
        live = live_sph = live_rect = gated = kept = tests = visits = pairs = walks = 0
        for _, k in pv.two_layers(scene, o, d, tau):
            tt, lv, at, _ = pv.soft_layer(scene, o, d, k, tau, (H, W))
            live += int(lv.sum())
            live_sph += int(((k >= 0) & (k < N)).sum())
            live_rect += int((k >= N).sum())
            so = pl.shadow_origin(o, d, tt, (at["nx"], at["ny"], at["nz"]))
            for li in range(L):
                ldir, dist = pl.light_geometry(scene.lights, li, so)
                alpha = pv.sphere_shadow_alpha(c, r, pv._lead(so), pv._lead(ldir), dist[None],
                                               tau)
                gated += int(((alpha > 0) & lv[None]).sum())
                kept += int((fvs.shadow_kept(c, r, pv._lead(so), pv._lead(ldir), dist[None], tau)
                             & lv[None]).sum())
                n = cull.warp_candidates(sp, so, lv, scene.lights.position[li], tau).sum(-1)
                lanes = torch.nn.functional.pad(lv, (0, -W % 32)).reshape(H, -1, 32).sum(-1)
                tests += int((lanes > 0).sum()) * N
                visits += int(n.sum())
                pairs += int((n * lanes).sum())
                walks += int((n > 0).sum())
        shadows = live * L if cfg.shadows else 0
    return dict(height=H, width=W, pixels=H * W, n_sph=N, n_rect=M, lights=L, live=live,
                live_sph=live_sph, live_rect=live_rect, ranked_sigmoid=ranked,
                checker=cfg.checker_tau > 0.0, **prim,
                shadow_tests=shadows * N, shadow_rect=shadows * M,
                shadow_gated=gated if cfg.shadows else 0,
                shadow_kept=kept if cfg.shadows else 0,
                warp_tests=tests if cfg.shadows else 0,
                warp_visits=visits if cfg.shadows else 0,
                candidate_pairs=pairs if cfg.shadows else 0, walks=walks if cfg.shadows else 0)


def _soft_shadow_cull_ops(c):
    """The soft shadow products over the warps' candidates (rows 7-9): per
    warp with a live lane the warp test of every sphere, per live lane of a
    candidate the per-pixel rule, and a kept pair at its soft test."""
    return (c["warp_tests"] * SOFT_OPS["warp_test"]
            + max(c["candidate_pairs"] - c["shadow_kept"], 0) * SOFT_OPS["shadow_cull"]
            + c["shadow_kept"] * SOFT_OPS["shadow_soft"])


def soft_render_ops(c, cull=False):
    """The soft forward's operations: every object ranked per pixel and
    every sphere's soft shadow test per live layer and light; ``cull``: row
    7's culls, the ranking over each warp's candidates of the widened cone
    and the shadow products over the warps' shadow candidates."""
    ops = (_common_ops(c) + c["ranked_sigmoid"] * SOFT_OPS["rank_sigmoid"]
           + c["live_sph"] * (OPS["surf_sphere"] + SOFT_OPS["layer_alpha"])
           + c["live_rect"] * OPS["surf_rect"]
           + c["checker"] * (c["live_sph"] * SOFT_OPS["checker_sphere"]
                             + c["live_rect"] * SOFT_OPS["checker_rect"])
           + c["live"] * (OPS["so"] + c["lights"] * (OPS["light"] + OPS["phong"]))
           + c["shadow_tests"] * SOFT_OPS["shadow_soft"] + c["shadow_rect"] * OPS["rect_shadow"]
           + c["pixels"] * SOFT_OPS["composite"])
    if cull:
        n = c["n_sph"]
        ops += (n * CULL_OPS["cone_sphere"] + c["warps"] * (CULL_OPS["cone_warp"]
                                                            + n * CULL_OPS["cone_test"])
                + (c["prim_pairs"] - c["pixels"] * n) * OPS["sphere_primary"]
                + (c["ranked_sigmoid_cull"] - c["ranked_sigmoid"]) * SOFT_OPS["rank_sigmoid"]
                + _soft_shadow_cull_ops(c) - c["shadow_tests"] * SOFT_OPS["shadow_soft"])
    return ops


def soft_step_ops(c, cull=True):
    """The soft step's operations; ``cull=False`` counts the shadow terms
    as before the cull."""
    if cull:
        shadow = _soft_shadow_cull_ops(c) + c["shadow_kept"] * SOFT_OPS["adj_shadow"]
    else:
        shadow = (c["shadow_tests"] * SOFT_OPS["shadow_soft"]
                  + c["shadow_gated"] * SOFT_OPS["adj_shadow"])
    return (soft_render_ops(c) - c["shadow_tests"] * SOFT_OPS["shadow_soft"] + shadow
            + OPS["cam_chain"]
            + c["pixels"] * (OPS["resid"] + OPS["sum_pixel"] + SOFT_OPS["adj_composite"]
                             + OPS["adj_camera"] + OPS["sum_hit"])
            + c["live"] * (OPS["adj_base"] + c["lights"] * (OPS["adj_light"] + OPS["sum_light"]))
            + c["live_sph"] * (OPS["adj_sphere"] + SOFT_OPS["adj_alpha"] + OPS["sum_sphere"])
            + c["live_rect"] * (OPS["adj_rect"] + OPS["sum_rect"])
            + c["checker"] * (c["live_sph"] * (SOFT_OPS["adj_checker_sphere"]
                                               + SOFT_OPS["sum_checker"])
                              + c["live_rect"] * (SOFT_OPS["adj_checker_rect"]
                                                  + SOFT_OPS["sum_checker"])))


def phase_soft_times():
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec, fused_vec_soft

    stream = torch.cuda.current_stream().cuda_stream
    saved = {k.name: k.launches for k in _all_kernels()}
    rows = {}
    for label, n_spheres, size, tau in SOFT_CASES:
        if label not in SOFT_TIMED:
            continue
        scene, start, cfg = _soft_case(n_spheres, size, tau)
        H, W = cfg.height, cfg.width
        target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        glob, sph, rct = fused_vec_soft._cuda_inputs(start, cfg)
        geom = fused_vec._geometry(start, cfg)
        img = torch.empty((H, W, 3), device="cuda")
        scratch = torch.empty((fused_vec_soft.SOFT_STEP.lib().rrt_soft_step_scratch_floats(
            *geom[2:7]),), device="cuda")
        out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device="cuda")
        w = 1.0 / (H * W * 3)
        render = lambda: fused_vec_soft.SOFT_RENDER.call(  # noqa: E731
            "rrt_soft_render", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom, tau, 0.0,
            img.data_ptr(), stream)
        render_ms, render_device = time_ms(render), device_ms(render)
        step = lambda: fused_vec_soft.SOFT_STEP.call(  # noqa: E731
            "rrt_soft_step", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom, tau, 0.0,
            target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), stream)
        step_ms, step_device = time_ms(step), device_ms(step)
        render_plain_ms = time_ms(lambda: fused_vec_soft.render_vec_soft_plain(start, cfg),
                                  reps=5, warmup=1)
        step_plain_ms = time_ms(
            lambda: fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target), reps=5, warmup=1)
        c = soft_work_counts(start, cfg)
        Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
        in_rows = 4 * (Sg + ns_pad * 17 + nr_pad * 22)
        s_bytes = vec_step_bytes(H * W, Sg, ns_pad, nr_pad)
        r_bytes = in_rows + 4 * H * W * 3
        s_bound = bound(soft_step_ops(c), s_bytes)
        rows[label] = dict(render_ms=render_ms, step_ms=step_ms, render_plain_ms=render_plain_ms,
                           step_plain_ms=step_plain_ms,
                           render_bound=bound(soft_render_ops(c, cull=True), r_bytes),
                           render_bound_uncull=bound(soft_render_ops(c), r_bytes),
                           render_device=render_device, step_device=step_device,
                           step_bound=s_bound,
                           step_bound_uncull=bound(soft_step_ops(c, cull=False), s_bytes),
                           kept_pairs=c["shadow_kept"], all_pairs=c["shadow_tests"],
                           render_ops=soft_render_ops(c, cull=True),
                           render_ops_uncull=soft_render_ops(c), step_ops=soft_step_ops(c),
                           cull=soft_cull_counters(c), work=c,
                           step_rays_per_s=H * W / (step_ms * 1e-3))
    for k in _all_kernels():
        k.launches = saved[k.name]
    emit("soft_times", ok=True, rows=rows)
    return rows

# ---------------------------------------------------------------------------
# The render backward kernels (rows 3, 5, 8): a differentiable render
# ---------------------------------------------------------------------------

# (label, family, spheres, size, tau, perturb scale and lr of the main run):
# config 2 at bench.py's 512^2, config 5 at its BASELINE 1024^2, and config 5
# at the anneal's soft size and first stage (the scales and rates of the
# CLI runs of phases main, vec_main and anneal_main).
GRAD_CASES = (("config2_512", "fused", 4, 512, 0.0, 0.1, 1e-2),
              ("config5_1024", "vec", 64, 1024, 0.0, 0.05, 1e-2),
              ("config5_512_t0.08", "soft", 64, 512, 0.08, 0.03, 2e-3))
BWD_NAMES = {"fused": "fused_render_bwd", "vec": "fused_vec_render_bwd",
             "soft": "fused_vec_soft_render_bwd"}
FWD_NAMES = {"fused": "fused_render", "vec": "fused_vec_render", "soft": "fused_vec_soft_render"}
BWD_REPLACES = {"fused": "reversible_raytracer_tpu/ops/kernels/fused.py:252",
                "vec": "reversible_raytracer_tpu/ops/kernels/fused_vec.py:979",
                "soft": "reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:547"}


def _grad_case(family, n_spheres, size, tau):
    import dataclasses

    from reversible_raytracer_tpu_torch.models import configs

    if family == "fused":
        scene, spec, cfg = configs.config2_four_spheres(size=size, device="cuda")
    else:
        scene, spec, cfg = configs.config5_many_spheres(size=size, n_spheres=n_spheres,
                                                        device="cuda")
    return scene, spec, dataclasses.replace(cfg, soft_tau=tau)


def _grad_start(family, scene, spec):
    from reversible_raytracer_tpu_torch.models import configs

    return configs.perturb(scene, spec, scale=0.1 if family == "fused" else 0.05, seed=4)


def _bwd(scene, cfg, g):
    """The scene's gradient for cotangent ``g`` by the main path's route,
    autograd of `render`: one forward and one backward-kernel launch."""
    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.render import render

    return fused.autograd_vjp(render, scene, cfg, g)


def _bwd_plain(family):
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    return {"fused": fused.render_fused_bwd_plain, "vec": fused_vec.render_vec_bwd_plain,
            "soft": fused_vec_soft.render_vec_soft_bwd_plain}[family]


def _seeded_cotangent(cfg):
    import numpy as np
    import torch

    g = np.random.default_rng(0).normal(size=(cfg.height, cfg.width, 3)).astype(np.float32)
    return torch.from_numpy(g).cuda()


def phase_render_grad():
    """Rows 3, 5 and 8, reached as the main path reaches them (autograd of
    `render`), against their plain versions and against the step kernels'
    mse gradient; returns each family's largest absolute gradient
    difference from its plain version."""
    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten
    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render

    rows, max_abs = [], {}
    for label, family, n_spheres, size, tau, *_ in GRAD_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        start = _grad_start(family, scene, spec)
        target = render(scene, cfg)
        g = _seeded_cotangent(cfg)
        kernel = {k.name: k for k in _all_kernels()}[BWD_NAMES[family]]
        before = kernel.launches
        got = _bwd(start, cfg, g)
        one_launch = kernel.launches == before + 1
        again = [_bwd(start, cfg, g) for _ in range(2)]
        plain = _bwd_plain(family)(start, cfg, g)
        leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
        ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
        grads = lambda: [torch.zeros_like(l) if l.grad is None else l.grad  # noqa: E731
                         for l in leaves]
        by_render = tree_unflatten(start, grads())
        by_step = loss_and_grad_fn(start, cfg)(start, target)[1]
        for l in leaves:
            l.grad = None
        render(tree_unflatten(start, leaves), cfg).sum().backward()
        expanded = torch.cat([x.reshape(-1) for x in grads()])
        ones = _bwd(start, cfg, torch.ones_like(g))
        torch.cuda.synchronize()
        row = dict(case=label, kernel=BWD_NAMES[family], one_launch=one_launch,
                   deterministic=all(torch.equal(fused.flatten_scene(got),
                                                 fused.flatten_scene(a)) for a in again),
                   expanded_cotangent_same=bool(torch.equal(expanded, fused.flatten_scene(ones))),
                   mse_bit_equal=bool(torch.equal(fused.flatten_scene(by_render),
                                                  fused.flatten_scene(by_step))))
        checks = [("plain", plain, got), ("mse_vs_step", by_step, by_render)]
        if family == "soft":  # row 8 against its eager twin too
            from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft

            checks.append(("twin", fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                           got))
        for name, ref, test in checks:
            errs = _grad_errors(ref, test)
            worst = max(errs, key=errs.get)
            row[name] = dict(worst_leaf=worst, worst_err=errs[worst])
        max_abs[family] = max(float((a - b).abs().max())
                              for a, b in zip(tree_leaves(plain), tree_leaves(got)) if a.numel())
        row["plain"]["max_abs_err"] = max_abs[family]
        rows.append(row)
        if not (all(row[name]["worst_err"] <= 1e-2 for name, *_ in checks)
                and row["one_launch"] and row["deterministic"]
                and row["expanded_cotangent_same"]
                and (row["mse_bit_equal"] or family == "soft")):
            raise AssertionError(f"render backward kernel failed a check: {row}")
    emit("render_grad", ok=True, rows=rows)
    return max_abs


GRAD_ITERS = 20


def phase_render_grad_main():
    """optimize(render_fn=render): each step autograd through the forward and
    the backward kernel. Returns the launch counts of each shape's run."""
    import time

    import torch

    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize, param_error
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.render import render

    rows, counts = [], {}
    for label, family, n_spheres, size, tau, scale, lr in GRAD_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        for k in _all_kernels():
            k.launches = 0
        t0 = time.perf_counter()
        target = render(scene, cfg)
        start = configs.perturb(scene, spec, scale=scale, seed=0)
        final, _, losses = optimize(start, target, spec, cfg, OptConfig(iters=GRAD_ITERS, lr=lr),
                                    log_every=0, render_fn=lambda s, cfg=cfg: render(s, cfg))
        la = losses.cpu().tolist()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _all_kernels()}
        expect = {FWD_NAMES[family]: GRAD_ITERS + 1, BWD_NAMES[family]: GRAD_ITERS}
        row = dict(case=label, launches=launches, expected=expect, first_loss=la[0],
                   final_loss=la[-1], start_param_err=float(param_error(start, scene, spec)),
                   param_err=float(param_error(final, scene, spec)), wall_seconds=wall)
        rows.append(row)
        counts[label] = launches
        ok = (all(launches[name] == expect.get(name, 0) for name in launches)
              and all(math.isfinite(x) for x in la) and la[-1] < la[0])
        if not ok:
            raise AssertionError(f"optimize(render_fn=render) did not run through the forward "
                                 f"and backward kernels only, or did not descend: {row}")
    emit("render_grad_main", ok=True, rows=rows)
    return counts


# The backward's operations: the step's, without the shadow rays' any-hit
# tests for the hard families (the planes are read instead), and with the
# caller's cotangent times the clip gradient (3 multiplies) in place of the
# residual and the squared error.
OPS_COT = 3


def bwd_ops(c, cull=False):
    """The render backward's operations: the step's without its shadow rays
    (``cull``: with the primary cull, as rows 5-6 walk)."""
    ops = (step_ops(c) - c["pixels"] * (OPS["resid"] + OPS["sum_pixel"] - OPS_COT)
           - c["shadow_sph_hit"] * OPS["sphere_shadow"]
           - c["shadow_rect_hit"] * OPS["rect_shadow"])
    if cull:
        culled, full = _cull_ops(c, shadows=False)
        ops += culled - full
    return ops


def soft_bwd_ops(c, cull=True):
    return soft_step_ops(c, cull) - c["pixels"] * (OPS["resid"] + OPS["sum_pixel"] - OPS_COT)


def _raw_calls(family, start, cfg, g, target):
    """(forward, backward, step or None) of the family's functions at
    ``cfg.spp`` as calls of their C entries on fixed buffers (no wrapper,
    no counter): rows 2, 3, 1 and 6 one call with the spp; rows 4, 5, 7 and
    8 one call at each subsample's offsets (the backward given ``g`` over
    the spp, as autograd of the average gives it each launch); row 9 at spp
    1 only. The forward runs once here, so the planes the backward reads
    are this scene's. Then the three's bounds (`spp_work`: each pixel's work
    once a subsample, the scene's once; bytes: each input read once and
    each output written once, the image once and spp L planes) and the work
    counts."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
    from reversible_raytracer_tpu_torch.ops.pipeline import SPP_OFFSETS

    stream = torch.cuda.current_stream().cuda_stream
    H, W, spp = cfg.height, cfg.width, cfg.spp
    offs, planes = SPP_OFFSETS[spp], spp * start.lights.count
    w = 1.0 / (H * W * 3)
    img = torch.empty((H, W, 3), device="cuda")
    if family == "fused":
        flat = fused._cuda_flat(start, cfg)
        geom = fused._geometry(start, cfg)
        S = flat.numel()
        vis = torch.empty((planes, H, W), device="cuda")
        scratch = torch.empty((fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5]),),
                              device="cuda")
        out = torch.empty((1 + S,), device="cuda")
        fwd = lambda: fused.FUSED_RENDER.call(  # noqa: E731
            "rrt_render_spp", flat.data_ptr(), *geom, spp, img.data_ptr(), vis.data_ptr(), stream)
        bwd = lambda: fused.FUSED_RENDER_BWD.call(  # noqa: E731
            "rrt_render_bwd_spp", flat.data_ptr(), *geom, spp, g.data_ptr(), vis.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), stream)
        step = lambda: fused.FUSED_STEP.call(  # noqa: E731
            "rrt_step_spp", flat.data_ptr(), *geom, spp, target.data_ptr(), w,
            scratch.data_ptr(), out.data_ptr(), stream)
        fwd()
        c = spp_work(work_counts, start, cfg)
        return fwd, bwd, step, dict(
            fwd=bound(render_ops(c, misses=False), 4 * (S + H * W * (3 + planes))),
            bwd=bound(bwd_ops(c), 4 * (S + H * W * (3 + planes) + 1 + S)),
            step=bound(step_ops(c), 4 * (S + H * W * 3 + 1 + S))), c
    glob, sph, rct = fused_vec.packed_inputs(start)
    geom = fused_vec._geometry(start, cfg)
    Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
    n_rows = 4 * (Sg + ns_pad * 17 + nr_pad * 22)
    outs = [torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device="cuda")
            for _ in offs]
    imgs = [img] + [torch.empty((H, W, 3), device="cuda") for _ in offs[1:]]
    g_sub = g if spp == 1 else (g * (1.0 / spp)).contiguous()

    def rows():  # the functions below keep the row tensors alive through this
        return glob.data_ptr(), sph.data_ptr(), rct.data_ptr()

    if family == "vec":
        vis = [torch.empty((planes // spp, H, W), device="cuda") for _ in offs]
        scratch = torch.empty((fused_vec.VEC_STEP.lib().rrt_vec_step_scratch_floats(
            *geom[2:7]),), device="cuda")

        def fwd():
            for (oi, oj), im, v in zip(offs, imgs, vis):
                fused_vec.VEC_RENDER.call("rrt_vec_render_at", *rows(), *geom, oi, oj,
                                          im.data_ptr(), v.data_ptr(), stream)

        def bwd():
            for (oi, oj), v, o in zip(offs, vis, outs):
                fused_vec.VEC_RENDER_BWD.call("rrt_vec_render_bwd_at", *rows(), *geom, oi, oj,
                                              g_sub.data_ptr(), v.data_ptr(), scratch.data_ptr(),
                                              o.data_ptr(), stream)

        step = lambda: fused_vec.VEC_STEP.call(  # noqa: E731
            "rrt_vec_step_spp", *rows(), *geom, spp, target.data_ptr(), w, scratch.data_ptr(),
            outs[0].data_ptr(), stream)
        fwd()
        c = spp_work(lambda s, cf, off: work_counts(s, cf, cull=True, off=off), start, cfg)
        b_bytes = 2 * n_rows + 4 * (H * W * (3 + planes) + 1)
        c["bound_uncull"] = bound(bwd_ops(c), b_bytes)
        c["cull"] = cull_counters(c)
        return fwd, bwd, step, dict(
            fwd=bound(render_ops(c, cull=True), n_rows + 4 * H * W * (3 + planes)),
            bwd=bound(bwd_ops(c, cull=True), b_bytes),
            step=bound(step_ops(c, cull=True), 2 * n_rows + 4 * (H * W * 3 + 1))), c
    tau, ctau = float(cfg.soft_tau), float(cfg.checker_tau)
    scratch = torch.empty((fused_vec_soft.SOFT_STEP.lib().rrt_soft_step_scratch_floats(
        *geom[2:7]),), device="cuda")

    def fwd():
        for (oi, oj), im in zip(offs, imgs):
            fused_vec_soft.SOFT_RENDER.call("rrt_soft_render_at", *rows(), *geom, oi, oj, tau,
                                            ctau, im.data_ptr(), stream)

    def bwd():
        for (oi, oj), o in zip(offs, outs):
            fused_vec_soft.SOFT_RENDER_BWD.call("rrt_soft_render_bwd_at", *rows(), *geom, oi, oj,
                                                tau, ctau, g_sub.data_ptr(), scratch.data_ptr(),
                                                o.data_ptr(), stream)

    step = None if spp != 1 else lambda: fused_vec_soft.SOFT_STEP.call(
        "rrt_soft_step", *rows(), *geom, tau, ctau, target.data_ptr(), w, scratch.data_ptr(),
        outs[0].data_ptr(), stream)
    c = spp_work(soft_work_counts, start, cfg)
    b_bytes = 2 * n_rows + 4 * (H * W * 3 + 1)
    c["bound_uncull"] = bound(soft_bwd_ops(c, cull=False), b_bytes)
    return fwd, bwd, step, dict(fwd=bound(soft_render_ops(c, cull=True), n_rows + 4 * H * W * 3),
                                bwd=bound(soft_bwd_ops(c), b_bytes)), c


def phase_render_grad_times():
    """Each backward kernel, its plain version, forward + backward and the
    matching step kernel (CUDA events, median of 20 after 3 warm-ups; the
    plain version 10 or 5), beside the backward's bound."""
    from reversible_raytracer_tpu_torch.ops.render import render

    saved = {k.name: k.launches for k in _all_kernels()}
    rows = {}
    for label, family, n_spheres, size, tau, *_ in GRAD_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        start = _grad_start(family, scene, spec)
        target = render(scene, cfg)
        g = _seeded_cotangent(cfg)
        fwd, bwd, step, bounds, c = _raw_calls(family, start, cfg, g, target)
        plain = _bwd_plain(family)
        soft = family == "soft"
        rows[label] = dict(
            bwd_ms=time_ms(bwd), bwd_device=device_ms(bwd),
            plain_ms=time_ms(lambda: plain(start, cfg, g), reps=5 if soft else 10,
                             warmup=1 if soft else 3),
            fwd_bwd_ms=time_ms(lambda: (fwd(), bwd())), step_ms=time_ms(step),
            bound=bounds["bwd"],
            ops=soft_bwd_ops(c) if soft else bwd_ops(c, cull=family == "vec"), work=c)
        rows[label]["rays_per_s"] = cfg.height * cfg.width / (rows[label]["bwd_ms"] * 1e-3)
    for k in _all_kernels():
        k.launches = saved[k.name]
    if rows["config2_512"]["bwd_device"]["launches"] != 1:  # one cooperative launch a call
        raise AssertionError(f"row 3 did not make one launch a call: "
                             f"{rows['config2_512']['bwd_device']}")
    emit("render_grad_times", ok=True, rows=rows)
    return rows


# The loop phase's paths: (label, family, spheres, size, soft_tau, perturb scale,
# lr, steps, route): the step kernels' routes of phases 5, 10 and 14 (rows 1,
# 6, 9) and the render_fn route of phase 17 for the small-scene family (rows 2+3).
LOOP_CASES = (("config2_512", "fused", 4, 512, 0.0, 0.1, 1e-2, 50, "step"),
              ("config5_1024", "vec", 64, 1024, 0.0, 0.05, 1e-2, 20, "step"),
              ("config5_512_t0.08", "soft", 64, 512, 0.08, 0.03, 2e-3, 20, "step"),
              ("config2_512_render_fn", "fused", 4, 512, 0.0, 0.1, 1e-2, 20, "render"))
STEP_NAMES = {"fused": "fused_step", "vec": "fused_vec_step", "soft": "fused_vec_soft_step"}
LOOP_CHUNK = 7


def _host_ms(fn, n):
    """Host milliseconds a step of ``fn`` (n steps), the card synchronized at
    both ends."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _idle_share(fn, n):
    """1 - the kernels' summed device time / the wall time of ``fn`` (n
    steps): torch.profiler's device time over 3 calls, the host clock's
    median over 3 others."""
    import statistics

    dev = device_ms(fn, reps=3, warmup=1)
    wall = statistics.median(_host_ms(fn, 1) for _ in range(3))
    return dict(idle_share=1.0 - dev["ms"] / wall, device_ms_per_step=dev["ms"] / n,
                wall_ms_per_step=wall / n, kernels_traced=len(dev["kernels"]),
                launches_per_step=dev["launches"] / n)


def phase_loop():
    """The training loop eager (`make_eager_step`: every launch from the
    host) and captured (`make_step`: one CUDA graph replay a step) from the
    same start on each path of LOOP_CASES: the per-step losses and the final
    trainable vector bit for bit, `optimize_scan` in chunks of LOOP_CHUNK bit
    for bit one chunk, the launches of the captured loop (one of each kernel
    a step), the host ms a step of each loop, and the device's idle share
    over one chunk of steps of each."""
    import torch

    from reversible_raytracer_tpu_torch import optim
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.render import render

    rows = []
    for label, family, n_spheres, size, tau, scale, lr, n, route in LOOP_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        target = render(scene, cfg).detach()
        start = configs.perturb(scene, spec, scale=scale, seed=0)
        ocfg = optim.OptConfig(iters=n, lr=lr)
        render_fn = (lambda s, cfg=cfg: render(s, cfg)) if route == "render" else None
        flags = optim.trainable_flags(spec)
        runs = {}
        for mode, make in (("eager", optim.make_eager_step), ("captured", optim.make_step)):
            step, init = make(cfg, spec, ocfg, render_fn=render_fn)
            losses = torch.empty((n,), device="cuda")
            box = {"scene": start, "state": init(start)}

            def steps(first, last, step=step, box=box, losses=losses):
                for i in range(first, last):
                    box["scene"], box["state"], loss, _ = step(box["scene"], box["state"],
                                                               target)
                    losses[i] = loss

            for k in _all_kernels():
                k.launches = 0
            first_ms = _host_ms(lambda: steps(0, 1), 1)  # the captured one captures here
            ms = _host_ms(lambda: steps(1, n), n - 1)
            runs[mode] = dict(losses=losses.clone(),
                              launches={k.name: k.launches for k in _all_kernels() if k.launches},
                              flat=optim.ravel_trainable(box["scene"], flags).clone(),
                              first_step_ms=first_ms, ms_per_step=ms,
                              loop_ms_per_step=(first_ms + ms * (n - 1)) / n)
            # one more chunk of steps from where the loop ended, under the profiler
            runs[mode]["chunk"] = _idle_share(lambda: steps(0, LOOP_CHUNK), LOOP_CHUNK)
        one, one_losses = optim.optimize_scan(start, target, spec, cfg, ocfg,
                                              render_fn=render_fn)
        chunked, chunk_losses = optim.optimize_scan(start, target, spec, cfg, ocfg,
                                                    render_fn=render_fn, max_chunk=LOOP_CHUNK)
        eager, captured = runs["eager"], runs["captured"]
        want = ({STEP_NAMES[family]: n} if route == "step"
                else {FWD_NAMES[family]: n, BWD_NAMES[family]: n})
        row = dict(
            case=label, route=route, steps=n,
            bit_equal=bool(torch.equal(eager["losses"], captured["losses"])
                           and torch.equal(eager["flat"], captured["flat"])),
            chunks_bit_equal=bool(torch.equal(one_losses, chunk_losses)
                                  and torch.equal(one_losses, captured["losses"])
                                  and torch.equal(optim.ravel_trainable(one, flags),
                                                  optim.ravel_trainable(chunked, flags))),
            launches=captured["launches"], expected=want,
            first_loss=float(captured["losses"][0]), final_loss=float(captured["losses"][-1]),
            **{f"{mode}_{key}": runs[mode][key] for mode in runs
               for key in ("loop_ms_per_step", "first_step_ms", "ms_per_step", "chunk")})
        rows.append(row)
        if not (row["bit_equal"] and row["chunks_bit_equal"] and captured["launches"] == want
                and eager["launches"] == want
                and math.isfinite(row["final_loss"]) and row["final_loss"] < row["first_loss"]):
            raise AssertionError(f"captured loop disagrees with the eager loop: {row}")
    emit("loop", ok=True, rows=rows)
    return {r["case"]: r for r in rows}


# ---------------------------------------------------------------------------
# Config 4: the soft checker (checker_tau > 0) of rows 7, 8 and 9
# ---------------------------------------------------------------------------

# Config 4 at its published 512^2, at the anneal's first stage (tau 0.08,
# checker_tau = 12.5 * 0.08 = 1.0, the recipe's checker_ratio).
CHECKER_SIZE, CHECKER_TAU, CHECKER_CTAU = 512, 0.08, 1.0
# The camera's eye, look_at and up gradients come from one chain (the basis
# from the ten ray-form cotangents), each held to the largest of the three:
# up's is a float32 cancellation far below eye's on config 4.
CAMERA_CHAIN = ("camera.eye", "camera.look_at", "camera.up")


def _chain_errors(ga, gb):
    """`_grad_errors`, the camera chain's leaves on the chain's scale."""
    errs = _grad_errors(ga, gb)
    leaves = {p: (getattr(ga.camera, p[7:]), getattr(gb.camera, p[7:])) for p in CAMERA_CHAIN}
    chain = max(float(a.abs().max()) for a, _ in leaves.values())
    for path, (a, b) in leaves.items():
        errs[path] = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-6, chain)
    return errs


def _worst(errs):
    worst = max(errs, key=errs.get)
    return dict(worst_leaf=worst, worst_err=errs[worst])


def phase_checker():
    """Rows 7, 8 and 9 with the soft checker (their SOFT_CHECKER instances)
    at config 4, 512^2, tau 0.08, checker_tau 1.0, from perturb(0.05, seed
    4): row 7 against its plain version by the rule of phase 3; row 9 and
    row 8 (reached by autograd of `render`, one launch a call) against
    autograd of the plain render and against their eager twins, every leaf
    within 1e-2 of its scale (`_chain_errors`), the camera's and the checker
    columns' included, the eye's gradient above 1e-6; three calls of each
    bit-identical; row 9 against row 7's own image a loss and every gradient
    exactly 0. On config 5 (no checkered material) at 512^2, tau 0.08, the
    three rows' instances at checker_tau 1.0 give the bits of checker_tau 0.
    Each row's event and device time, its plain version's, and its bound
    with the soft checker's operations, beside the device time of its hard
    checker's instance on the same inputs. Returns {row name: that row's
    numbers}."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
    from reversible_raytracer_tpu_torch.ops.render import resolve_impl

    saved = {k.name: k.launches for k in _all_kernels()}
    scene, spec, cfg = configs.config4_checker_camera(CHECKER_SIZE, device="cuda")
    cfg = dataclasses.replace(cfg, soft_tau=CHECKER_TAU, checker_tau=CHECKER_CTAU)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    # row 7
    img_k = fused_vec_soft.render_vec_soft(scene, cfg)
    img_p = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    torch.cuda.synchronize()
    err = (img_k - img_p).abs()
    fwd = dict(frac_bad=float((err > 2e-3).float().mean()), mean_err=float(err.mean()),
               max_abs_err=float(err.max()), bit_identical=bool(torch.equal(img_k, img_p)),
               finite=bool(torch.isfinite(img_k).all()))
    # row 9
    target = img_p
    runs = [fused_vec_soft.loss_grad_vec_soft(start, cfg, target) for _ in range(3)]
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    l_k, g_k = runs[0]
    l_p, g_p = fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target)
    l_a, g_a = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
    torch.cuda.synchronize()
    step = dict(loss=float(l_k), deterministic=all(torch.equal(flat[0], f) for f in flat[1:]),
                eye_grad=float(g_k.camera.eye.abs().max()),
                checker_grads={f"{grp}.{f}": float(getattr(getattr(g_k, grp).material, f)
                                                   .abs().max())
                               for grp in ("spheres", "rects")
                               for f in ("checker", "checker_scale")},
                max_abs_err=max(float((a - b).abs().max())
                                for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel()))
    for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
        step[name] = dict(loss_rel=abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12),
                          **_worst(_chain_errors(g_ref, g_k)))
    l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg, img_k)
    torch.cuda.synchronize()
    step["zero_residual_exact"] = bool(float(l_0) == 0.0 and not fused.flatten_scene(g_0).any())
    # row 8, by autograd of render
    g = _seeded_cotangent(cfg)
    before = fused_vec_soft.SOFT_RENDER_BWD.launches
    bwds = [_bwd(start, cfg, g) for _ in range(3)]
    b_plain = fused_vec_soft.render_vec_soft_bwd_plain(start, cfg, g)
    b_twin = fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g)
    torch.cuda.synchronize()
    bwd = dict(one_launch=fused_vec_soft.SOFT_RENDER_BWD.launches == before + 3,
               deterministic=all(torch.equal(fused.flatten_scene(bwds[0]), fused.flatten_scene(b))
                                 for b in bwds[1:]),
               plain=_worst(_chain_errors(b_plain, bwds[0])),
               twin=_worst(_chain_errors(b_twin, bwds[0])),
               max_abs_err=max(float((a - b).abs().max()) for a, b in
                               zip(tree_leaves(b_plain), tree_leaves(bwds[0])) if a.numel()))
    # the soft-checker instances on a scene without a checkered material: its
    # blend is c1 + 0 (c2 - c1), and at the true scene, where color2 is
    # color, the checker column's gradient par (c2 - c1) . g_base is 0 too
    s5, spec5, c5 = configs.config5_many_spheres(size=CHECKER_SIZE, device="cuda")
    c5 = dataclasses.replace(c5, soft_tau=CHECKER_TAU)
    c5k = dataclasses.replace(c5, checker_tau=CHECKER_CTAU)
    tgt5 = fused_vec_soft.render_vec_soft(configs.perturb(s5, spec5, scale=0.05, seed=4), c5)
    g5 = _seeded_cotangent(c5)

    def step_bits(c):
        l5, gr5 = fused_vec_soft.loss_grad_vec_soft(s5, c, tgt5)
        return torch.cat([l5.reshape(1), fused.flatten_scene(gr5)])

    same = dict(row7=bool(torch.equal(fused_vec_soft.render_vec_soft(s5, c5),
                                      fused_vec_soft.render_vec_soft(s5, c5k))),
                row9=bool(torch.equal(step_bits(c5), step_bits(c5k))),
                row8=bool(torch.equal(fused.flatten_scene(_bwd(s5, c5, g5)),
                                      fused.flatten_scene(_bwd(s5, c5k, g5)))))
    # times and bounds; beside them the hard checker's instances on the same
    # inputs (checker_tau 0), what the soft checker costs
    hard = _raw_calls("soft", start, dataclasses.replace(cfg, checker_tau=0.0), g, target)
    hard_device = dict(zip(("fused_vec_soft_render", "fused_vec_soft_render_bwd",
                            "fused_vec_soft_step"), (device_ms(f)["ms"] for f in hard[:3])))
    fwd_call, bwd_call, step_call, bounds, c = _raw_calls("soft", start, cfg, g, target)
    glob = fused_vec_soft._cuda_inputs(start, cfg)[0]
    Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
    times = {
        "fused_vec_soft_render": dict(
            ms=time_ms(fwd_call), device=device_ms(fwd_call),
            plain_ms=time_ms(lambda: fused_vec_soft.render_vec_soft_plain(start, cfg), reps=5,
                             warmup=1),
            bound=bounds["fwd"], max_abs_err=fwd["max_abs_err"]),
        "fused_vec_soft_step": dict(
            ms=time_ms(step_call), device=device_ms(step_call),
            plain_ms=time_ms(lambda: fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target),
                             reps=5, warmup=1),
            bound=bound(soft_step_ops(c), vec_step_bytes(cfg.height * cfg.width, Sg, ns_pad,
                                                                  nr_pad)),
            max_abs_err=step["max_abs_err"]),
        "fused_vec_soft_render_bwd": dict(
            ms=time_ms(bwd_call), device=device_ms(bwd_call),
            plain_ms=time_ms(lambda: fused_vec_soft.render_vec_soft_bwd_plain(start, cfg, g),
                             reps=5, warmup=1),
            bound=bounds["bwd"], max_abs_err=bwd["max_abs_err"])}
    for name, t in times.items():
        t["hard_checker_device_ms"] = hard_device[name]
    for k in _all_kernels():
        k.launches = saved[k.name]
    checks = dict(
        impl=resolve_impl(start, cfg) == "cuda_vec_soft",
        fwd=fwd["frac_bad"] < 1e-3 and fwd["mean_err"] < 1e-4 and fwd["finite"],
        step=(all(step[n]["loss_rel"] <= 1e-4 and step[n]["worst_err"] <= 1e-2
                  for n in ("autograd", "adjoint_eager"))
              and step["deterministic"] and step["zero_residual_exact"]
              and step["eye_grad"] > 1e-6 and step["checker_grads"]["rects.checker"] > 0.0),
        bwd=(bwd["one_launch"] and bwd["deterministic"] and bwd["plain"]["worst_err"] <= 1e-2
             and bwd["twin"]["worst_err"] <= 1e-2),
        unchecked_bits=all(same.values()))
    emit("checker", ok=all(checks.values()), checks=checks, case=f"config4_{CHECKER_SIZE}",
         tau=CHECKER_TAU, checker_tau=CHECKER_CTAU, render=fwd, step=step, render_bwd=bwd,
         config5_same_bits=same, times=times, work=c)
    if not all(checks.values()):
        raise AssertionError(f"the soft checker's kernels failed a check: {checks}")
    return times


# The config-4 paths of the CLI: the JAX package's recipe (tests/
# test_soft_checker.py:260: taus 0.08, 0.03, 0, checker_ratio 12.5, 100 Adam
# steps a stage at lr 5e-3 from perturb(0.05, seed 0)) at 512^2 and 64^2,
# and the hard inversion at 512^2 (50 steps).
CHECKER_ITERS = 100
CHECKER_RUNS = (("anneal_512", 512, True), ("anneal_64", 64, True), ("hard_512", 512, False))


def phase_checker_main():
    """The CLI's config-4 runs (CHECKER_RUNS) on the card, with the launch
    counts read around each: the anneal runs row 9 200 times (its two soft
    stages), row 7 twice (their targets), row 1 100 times (the hard polish,
    three objects) and row 2 twice (the target and the final image); the
    hard run row 1 50 times and row 2 twice; nothing else. Each stage's
    first and last loss, the eye's RMS error at the start and the end, and
    the loop's ms a step. At 64^2 the eye's RMS error must end below 0.02 of
    its start (the JAX test's criterion). Returns each run's numbers."""
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.models import configs

    out_dir = REPO / "smoke_out"
    rows = {}
    for label, size, anneal in CHECKER_RUNS:
        truth, spec, _ = configs.config4_checker_camera(size, device="cuda")
        start = configs.perturb(truth, spec, scale=0.05, seed=0)

        def eye_rms(s, truth=truth):
            return float(((s.camera.eye - truth.camera.eye) ** 2).mean().sqrt())

        png = out_dir / f"final_config4_{label}.png"
        argv = ["invert", "--config", "4", "--size", str(size), "--seed", "0", "--perturb",
                "0.05", "--quiet", "--metrics", str(out_dir / f"metrics_config4_{label}.jsonl"),
                "-o", str(png)]
        if anneal:
            argv += ["--anneal", "0.08,0.03,0", "--checker-ratio", "12.5", "--lr", "5e-3",
                     "--iters", str(CHECKER_ITERS)]
            expect = {"fused_vec_soft_step": 2 * CHECKER_ITERS, "fused_vec_soft_render": 2,
                      "fused_step": CHECKER_ITERS, "fused_render": 2}
        else:
            argv += ["--iters", "50", "--log-every", "49"]
            expect = {"fused_step": 50, "fused_render": 2}
        for k in _all_kernels():
            k.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _all_kernels()}
        if anneal:
            la = summary["losses"]
            stages = [la[i * CHECKER_ITERS:(i + 1) * CHECKER_ITERS] for i in range(3)]
            first_last, n_steps = [[st[0], st[-1]] for st in stages], len(la)
        else:
            hist = summary["history"]
            first_last, n_steps = [[hist[0]["loss"], hist[-1]["loss"]]], 50
        row = dict(launches=launches, expected=expect, stage_first_last=first_last,
                   eye_rms_start=eye_rms(start), eye_rms_end=eye_rms(summary["scene"]),
                   param_err=summary["param_err"], loop_seconds=summary["seconds"],
                   loop_ms_per_step=summary["seconds"] * 1e3 / n_steps, wall_seconds=wall,
                   png_bytes=png.stat().st_size if png.exists() else 0)
        row["eye_rms_ratio"] = row["eye_rms_end"] / row["eye_rms_start"]
        rows[label] = row
        ok = (all(launches[name] == expect.get(name, 0) for name in launches)
              and all(math.isfinite(x) for st in first_last for x in st) and png.exists()
              and (label != "anneal_64" or row["eye_rms_ratio"] < 0.02))
        if not ok:
            raise AssertionError(f"config 4's {label} run did not run through the expected "
                                 f"kernels, or did not recover the camera: {row}")
    emit("checker_main", ok=True, rows=rows)
    return rows


# ---------------------------------------------------------------------------
# spp 4 (2x2 supersampling): rows 1, 2, 3 and 6 loop over the subsamples in
# the kernel; rows 4, 5, 7 and 8 make one launch a subsample
# ---------------------------------------------------------------------------

# (label, family, spheres, size, soft_tau): each row's full-width shape, as
# phases 3-4 (rows 1-3), 8-9 (rows 4-6) and 12 (rows 7-8) hold them at spp 1.
SPP4_CASES = (("config2_512", "fused", 4, 512, 0.0), ("config5_1024", "vec", 64, 1024, 0.0),
              ("config5_512_t0.08", "soft", 64, 512, 0.08))
def _check_grads(row, name, ref, got, tol=1e-2, exact=None):
    """Record the worst leaf of ``got`` against ``ref`` (``tol`` of its
    scale holds) and its largest absolute difference. With ``exact`` (a
    function giving ``ref``'s float64 counterpart), a leaf over ``tol``
    passes if it is within ``tol`` of the float64 gradient, or, where
    float32 does not determine it so closely, if its distance to ``ref`` is
    no more than ``ref``'s own to the float64 gradient, and at most 1e-2
    (``over_tol`` records each such leaf's three distances)."""
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves

    errs = _grad_errors(ref, got)
    worst = max(errs, key=errs.get)
    row[name] = dict(worst_leaf=worst, worst_err=errs[worst], tol=tol, max_abs_err=max(
        float((a - b).abs().max()) for a, b in zip(tree_leaves(ref), tree_leaves(got))
        if a.numel()))
    over = [leaf for leaf, e in errs.items() if e > tol]
    if not over or exact is None:
        return not over
    ex = exact()
    ref_f64, got_f64 = _grad_errors(ex, ref), _grad_errors(ex, got)
    row[name]["over_tol"] = {leaf: dict(to_plain=errs[leaf], plain_to_f64=ref_f64[leaf],
                                        to_f64=got_f64[leaf]) for leaf in over}
    return all(got_f64[leaf] <= tol or errs[leaf] <= min(1e-2, ref_f64[leaf]) for leaf in over)


def _f64(tree):
    """``tree`` (a scene, or a tensor) in float64."""
    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_map

    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float64)
    return tree_map(lambda x: x.to(torch.float64), tree)


def phase_spp4():
    """Rows 1-8 at spp 4 at each family's full-width shape (SPP4_CASES),
    reached as the main path reaches them, by the rules of phases 3, 4, 9,
    13 and 16: rows 2 and 4 bit for bit their plain versions (the image;
    each subsample's planes on the pixels its ray hit, 0 where it hit
    nothing), row 7 within 1e-6; rows 1 and 6 against autograd and their
    eager twins (loss within 1e-4 relative, every leaf within 1e-2 of its
    scale) and, given the forward kernel's own spp-4 image, a loss and every
    gradient of exactly 0; rows 3, 5 and 8 (autograd of `render`) against
    autograd of the plain render and their eager twins, every leaf within
    1e-2 of its scale; every call's wrapper launches (one a call for rows 1,
    2, 3 and 6, four for rows 4, 5, 7 and 8); two calls bit-identical; row 9
    refuses spp 4 by name and launches nothing. Then each row's event time,
    device time and launches per call (profiler) on its C entries, its
    plain version's time and its bound. Returns each kernel's numbers."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec

    saved = {k.name: k.launches for k in _all_kernels()}
    kern = {k.name: k for k in _all_kernels()}
    forwards = {
        "fused": (fused.render_fused, fused.render_fused_plain),
        "vec": (fused_vec.render_vec, fused_vec.render_vec_plain),
        "soft": (lambda s, c: (fused_vec_soft.render_vec_soft(s, c), None),
                 lambda s, c: (fused_vec_soft.render_vec_soft_plain(s, c), None))}
    steps = {"fused": (fused.loss_grad_fused, fused.loss_grad_fused_plain,
                       fused.loss_grad_adjoint_eager),
             "vec": (fused_vec.loss_grad_vec, fused_vec.loss_grad_vec_plain,
                     fused_vec.loss_grad_vec_adjoint_eager)}
    rows, numbers = [], {}
    for label, family, n_spheres, size, tau in SPP4_CASES:
        scene, spec, cfg1 = _grad_case(family, n_spheres, size, tau)
        cfg = dataclasses.replace(cfg1, spp=4)
        start = _grad_start(family, scene, spec)
        g = _seeded_cotangent(cfg)
        per_call = 1 if family == "fused" else 4
        row, oks = dict(case=label), []

        # ---- the forward (rows 2, 4, 7)
        call, plain = forwards[family]
        fname = FWD_NAMES[family]
        before = kern[fname].launches
        with torch.no_grad():
            img_k, vis_k = call(scene, cfg)
            launches = kern[fname].launches - before
            img_2, vis_2 = call(scene, cfg)
            img_p, vis_p = plain(scene, cfg)
        torch.cuda.synchronize()
        r = dict(wrapper_launches_per_call=launches, max_abs_err=float((img_k - img_p).abs().max()),
                 deterministic=bool(torch.equal(img_k, img_2) and (
                     vis_k is None or torch.equal(vis_k, vis_2))),
                 finite=bool(torch.isfinite(img_k).all()))
        if family == "soft":
            ok = r["max_abs_err"] <= 1e-6
        else:
            L = scene.lights.count
            ok = tuple(vis_k.shape) == tuple(vis_p.shape) == (4 * L, cfg.height, cfg.width)
            for q, off in enumerate(pl.SPP_OFFSETS[4]):
                o, d = pl.primary_rays(scene, cfg1, off)
                hit = nearest_vec(scene, o, d)[1] >= 0
                pk, pp = vis_k[q * L:(q + 1) * L], vis_p[q * L:(q + 1) * L]
                ok = ok and bool(torch.equal(pk[:, hit], pp[:, hit])) and not bool(
                    pk[:, ~hit].any())
            r["bit_identical"] = ok = ok and bool(torch.equal(img_k, img_p))
        row[fname] = r
        oks.append(ok and r["deterministic"] and r["finite"] and launches == per_call)

        # ---- the step (rows 1, 6): against autograd and the twin, and zero
        # against the forward's own image
        if family in steps:
            step, step_plain, twin = steps[family]
            sname = STEP_NAMES[family]
            before = kern[sname].launches
            l_k, g_k = step(start, cfg, img_k)
            launches = kern[sname].launches - before
            l_2, g_2 = step(start, cfg, img_k)
            l_0, g_0 = step(scene, cfg, img_k)
            r = dict(wrapper_launches_per_call=launches, loss=float(l_k),
                     deterministic=bool(torch.equal(
                         torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                         torch.cat([l_2.reshape(1), fused.flatten_scene(g_2)]))),
                     zero_residual_exact=bool(float(l_0) == 0.0
                                              and not fused.flatten_scene(g_0).any()))
            ok = r["deterministic"] and r["zero_residual_exact"] and launches == 1
            for name, ref in (("autograd", step_plain), ("adjoint_eager", twin)):
                l_r, g_r = ref(start, cfg, img_k)
                rel = abs(float(l_k) - float(l_r)) / max(abs(float(l_r)), 1e-12)
                ok = _check_grads(r, name, g_r, g_k) and ok and rel <= 1e-4
                r[name]["loss_rel"] = rel
            r["max_abs_err"] = r["autograd"]["max_abs_err"]
            row[sname] = r
            oks.append(ok)

        # ---- the render backward (rows 3, 5, 8), by autograd of `render`
        bname = BWD_NAMES[family]
        before = kern[bname].launches
        got = _bwd(start, cfg, g)
        launches = kern[bname].launches - before
        again = _bwd(start, cfg, g)
        r = dict(wrapper_launches_per_call=launches, deterministic=bool(torch.equal(
            fused.flatten_scene(got), fused.flatten_scene(again))))
        if family == "fused":
            twin = fused.render_bwd_adjoint_eager(start, cfg, g, fused.render_fused(start, cfg)[1])
        elif family == "vec":
            twin = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                          fused_vec.render_vec(start, cfg)[1])
        else:
            twin = fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g)
        ok = _check_grads(r, "plain", _bwd_plain(family)(start, cfg, g), got)
        ok = _check_grads(r, "twin", twin, got) and ok
        r["max_abs_err"] = r["plain"]["max_abs_err"]
        row[bname] = r
        oks.append(ok and r["deterministic"] and launches == per_call)

        # ---- row 9 refuses spp 4 by name, and launches nothing
        if family == "soft":
            before = kern["fused_vec_soft_step"].launches
            try:
                fused_vec_soft.loss_grad_vec_soft(start, cfg, img_k)
                refused = ""
            except NotImplementedError as exc:
                refused = str(exc)
            row["fused_vec_soft_step"] = dict(refusal=refused)
            oks.append("spp=4 in the soft step" in refused
                       and kern["fused_vec_soft_step"].launches == before)

        # ---- times: the C entries of each row at spp 4, the plain versions
        fwd, bwd, step, bounds, c = _raw_calls(family, start, cfg, g, img_k)
        plain_reps = dict(reps=3, warmup=1)
        timed = [(fname, fwd, bounds["fwd"], lambda: forwards[family][1](start, cfg)),
                 (bname, bwd, bounds["bwd"], lambda: _bwd_plain(family)(start, cfg, g))]
        if step is not None:
            timed.append((STEP_NAMES[family], step, bounds["step"],
                          lambda: steps[family][1](start, cfg, img_k)))
        for name, fn, b, plain_fn in timed:
            dev = device_ms(fn)
            row[name].update(ms=time_ms(fn), device_ms=dev["ms"], launches_per_call=dev["launches"],
                             device=dev, plain_ms=time_ms(plain_fn, **plain_reps),
                             bound_ms=b[0], bound_by=b[1])
            numbers[name] = dict(case=f"{label}_spp4", **{
                k: row[name][k] for k in ("ms", "device_ms", "launches_per_call",
                                          "wrapper_launches_per_call", "max_abs_err",
                                          "plain_ms", "bound_ms", "bound_by")})
        row["work"] = c
        rows.append(row)
        if not all(oks):
            raise AssertionError(f"a spp-4 kernel failed a check at {label}: {row}")
    for k in _all_kernels():
        k.launches = saved[k.name]
    emit("spp4", ok=True, rows=rows)
    return numbers


# The spp-4 runs of the CLI: (label, argv, the launches each kernel must make,
# the steps of each stage whose losses must fall).
SPP4_ANNEAL_TAUS = ANNEAL_TAUS
SPP4_RUNS = (
    ("invert_config2_512", ["invert", "--config", "2", "--size", "512", "--spp", "4", "--iters",
                            "50", "--perturb", "0.1", "--seed", "0", "--log-every", "1",
                            "--quiet"],
     {"fused_step": 50, "fused_render": 2}),
    ("invert_config5_1024", ["invert", "--config", "5", "--size", "1024", "--spp", "4",
                             "--iters", "20", "--seed", "0", "--log-every", "1", "--quiet"],
     {"fused_vec_step": 20, "fused_vec_render": 8}),
    ("anneal_config5_1024", ["invert", "--config", "5", "--size", "1024", "--spp", "4",
                             "--anneal", ",".join(str(t) for t in SPP4_ANNEAL_TAUS),
                             "--anneal-size", "512", "--lr", "2e-3", "--perturb", "0.03",
                             "--iters", str(ANNEAL_ITERS), "--seed", "0", "--quiet"],
     {"fused_vec_soft_render": 4 * 3 + 4 * 3 * ANNEAL_ITERS,
      "fused_vec_soft_render_bwd": 4 * 3 * ANNEAL_ITERS, "fused_vec_step": ANNEAL_ITERS,
      "fused_vec_render": 8}),
)


def phase_spp4_main():
    """The port's CLI at --spp 4 on the card, with the launch counts read
    around each run (every other kernel never): `render` for configs 1-10 at
    their native sizes (row 2 once, configs 5 and 10 row 4 four times); `invert
    --config 2 --size 512` (row 1 50 times, row 2 twice: the target and the
    final image); `invert --config 5 --size 1024` (row 6 20 times, row 4
    eight times); the annealed inversion (each soft stage's target four
    launches of row 7, each soft step autograd of the four-launch soft
    render, four launches of rows 7 and 8 replayed in its CUDA graph: row 7
    12 + 4 x 60 times, row 8 4 x 60, row 9 never; the hard polish row 6 20
    times; row 4 eight times). Each run's loss must fall (each stage's, for
    the anneal); its host ms a step. Returns each run's launch counts."""
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    rows, counts = {}, {}
    for num in range(1, 11):  # configs 6-10: the bounce, the texel grids, the sky
        png = out_dir / f"render_spp4_config{num}.png"
        for k in _all_kernels():
            k.launches = 0
        cli.main(["render", "--config", str(num), "--spp", "4", "-o", str(png)])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in _all_kernels()}
        expect = {"fused_vec_render": 4} if num in (5, 10) else {"fused_render": 1}
        rows[f"render_config{num}"] = dict(launches=launches, expected=expect,
                                           png_bytes=png.stat().st_size if png.exists() else 0)
        if not (all(launches[n] == expect.get(n, 0) for n in launches) and png.exists()):
            raise AssertionError(f"render --config {num} --spp 4 did not run through the "
                                 f"expected kernels: {rows[f'render_config{num}']}")
    for label, argv, expect in SPP4_RUNS:
        png = out_dir / f"final_spp4_{label}.png"
        for k in _all_kernels():
            k.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(argv + ["-o", str(png)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _all_kernels()}
        if "taus" in summary:  # the anneal's summary holds every stage's losses
            la = summary["losses"]
            stages = [la[i * ANNEAL_ITERS:(i + 1) * ANNEAL_ITERS]
                      for i in range(len(SPP4_ANNEAL_TAUS))]
        else:
            la = [h["loss"] for h in summary["history"]]
            stages = [la]
        row = dict(launches=launches, expected=expect,
                   stage_first_last=[[st[0], st[-1]] for st in stages],
                   stages_fall=[st[-1] < st[0] for st in stages],
                   start_param_err=summary.get("start_param_err"),
                   param_err=summary["param_err"], loop_seconds=summary["seconds"],
                   loop_ms_per_step=summary["seconds"] * 1e3 / len(la), wall_seconds=wall,
                   png_bytes=png.stat().st_size if png.exists() else 0)
        rows[label] = row
        counts[label] = launches
        ok = (all(launches[n] == expect.get(n, 0) for n in launches) and all(row["stages_fall"])
              and all(math.isfinite(x) for x in la) and png.exists()
              and math.isfinite(summary["param_err"]))
        if not ok:
            raise AssertionError(f"the spp-4 run {label} did not run through the expected "
                                 f"kernels, or a stage did not descend: {row}")
    emit("spp4_main", ok=True, rows=rows)
    return counts


# ---------------------------------------------------------------------------
# One mirror bounce in rows 1-3 (config 6)
# ---------------------------------------------------------------------------

MIRROR_SIZE = 512


def bounce_counts(scene, cfg, off=(0.0, 0.0)):
    """Level 0's `work_counts` and the bounce levels' work (``l1_*``, each of
    the ``cfg.reflections`` levels' counted as level 1's and summed): the
    reflected rays (one per pixel whose ray hit at every level above), their
    winners by type, lit (pixel, light) pairs and the shadow-ray sphere and
    rect tests of the any-hit walks (stopping at the first occluder) from the
    level's hits; of one subsample, at the offset ``off`` (`spp_work` sums
    them)."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl

    c = work_counts(scene, dataclasses.replace(cfg, reflections=0), off=off)
    H, W = cfg.height, cfg.width
    sp, rc = scene.spheres, scene.rects
    o, d = pl.primary_rays(scene, cfg, off)
    t, live, at = pl.trace_nearest(scene, o, d, cfg.shape)
    tests = [(1, lambda oo, dd, k=k: pl.intersect_sphere(oo, dd, sp.center[k], sp.radius[k]))
             for k in range(sp.count)]
    tests += [(2, lambda oo, dd, k=k: pl.intersect_rect(oo, dd, rc.origin[k], rc.edge_u[k],
                                                        rc.edge_v[k])[0])
              for k in range(rc.count)]
    sums = dict(l1_rays=0, l1_sph=0, l1_rect=0, l1_hit=0, l1_lit=0, l1_shadow_sph=0,
                l1_shadow_rect=0)
    for _ in range(cfg.reflections):
        n = (at["nx"], at["ny"], at["nz"])
        o1, d1 = pl.shadow_origin(o, d, t, n), pl.reflect_dir(d, n)
        t_best = torch.full((H, W), pl.BIG, device=scene.device)
        kind = torch.zeros((H, W), dtype=torch.int32, device=scene.device)
        for kk, test in tests:
            t1 = test(o1, d1)
            closer = t1 < t_best
            t_best = torch.where(closer, t1, t_best)
            kind = torch.where(closer, kk, kind)
        kind = torch.where(live, kind, 0)
        hit1 = kind > 0
        _, _, at1 = pl.trace_nearest(scene, o1, d1, cfg.shape)
        so1 = pl.shadow_origin(o1, d1, t_best, (at1["nx"], at1["ny"], at1["nz"]))
        lit, shadow = 0, {1: 0, 2: 0}
        for li in range(scene.lights.count):
            ldir, dist = pl.light_geometry(scene.lights, li, so1)
            done = torch.zeros((H, W), dtype=torch.bool, device=scene.device)
            for kk, test in tests:
                if cfg.shadows:
                    shadow[kk] += int((hit1 & ~done).sum())
                done = done | (test(so1, ldir) < dist)
            lit += int((hit1 & ~done).sum()) if cfg.shadows else int(hit1.sum())
        for key, v in (("l1_rays", int(live.sum())), ("l1_sph", int((kind == 1).sum())),
                       ("l1_rect", int((kind == 2).sum())), ("l1_hit", int(hit1.sum())),
                       ("l1_lit", lit), ("l1_shadow_sph", shadow[1]),
                       ("l1_shadow_rect", shadow[2])):
            sums[key] += v
        o, d, t, live, at = o1, d1, t_best, hit1, at1
    c.update(sums)
    return c


def _bounce_render_ops(c):
    """Row 2's operations beyond level 0's: per reflected ray its direction,
    its walk over every object and the blend; level 1's shading and shadow
    rays where it hit."""
    return (c["l1_rays"] * (OPS["reflect"] + OPS["blend"] + c["n_sph"] * OPS["sphere_shadow"]
                            + c["n_rect"] * OPS["rect_shadow"])
            + c["l1_sph"] * OPS["surf_sphere"] + c["l1_rect"] * OPS["surf_rect"]
            + c["l1_hit"] * (OPS["so"] + c["lights"] * OPS["light"]) + c["l1_lit"] * OPS["phong"])


def _bounce_step_ops(c, shadows=True):
    """Row 1's (``shadows``) or row 3's operations beyond level 0's: row 2's
    bounce work (the shadow walks only where the step casts them), the
    blend's and the reflection's adjoints, level 1's shade and winner
    adjoints and their adds into the sums."""
    ops = (_bounce_render_ops(c)
           + c["l1_rays"] * (OPS["adj_blend"] + OPS["adj_reflect"] + OPS["sum_mirror"])
           + c["l1_hit"] * OPS["adj_base"]
           + c["l1_sph"] * (OPS["adj_sphere"] + OPS["sum_sphere"])
           + c["l1_rect"] * (OPS["adj_rect"] + OPS["sum_rect"])
           + c["l1_lit"] * (OPS["adj_light"] + OPS["sum_light"]))
    if shadows:
        ops += c["l1_shadow_sph"] * OPS["sphere_shadow"] + c["l1_shadow_rect"] * OPS["rect_shadow"]
    return ops


def mirror_bounds(c, S, planes):
    """Rows 2, 1 and 3's bounds with a bounce level: (ms, by) each."""
    H, W = c["height"], c["width"]
    return dict(
        fused_render=bound(render_ops(c, misses=False) + _bounce_render_ops(c),
                           4 * (S + H * W * (3 + planes))),
        fused_step=bound(step_ops(c) + _bounce_step_ops(c), 4 * (S + H * W * 3 + 1 + S)),
        fused_render_bwd=bound(bwd_ops(c) + _bounce_step_ops(c, shadows=False),
                               4 * (S + H * W * (3 + planes) + 1 + S)))


def _mirror_case(size=MIRROR_SIZE):
    from reversible_raytracer_tpu_torch.models import configs

    scene, spec, cfg = configs.config6_mirror(size=size, device="cuda")
    return scene, spec, cfg, configs.perturb(scene, spec, scale=0.3, seed=3)


def _level_planes(vis_k, vis_p, L, cfg, hits_at):
    """Each subsample's planes of each level, the kernel's ``vis_k`` against
    the plain version's ``vis_p`` (`pipeline.n_vis_planes`' layout: (1 + R)
    L a subsample, bounce-major): the same where that level's ray at the
    subsample's offset hit (``hits_at(off)``: each level's hits), 0
    elsewhere. Keys ``level{l}`` at spp 1, ``s{q}_level{l}`` at spp 4."""
    import torch

    from reversible_raytracer_tpu_torch.ops.pipeline import SPP_OFFSETS

    offs, P = SPP_OFFSETS[cfg.spp], L * (1 + cfg.reflections)
    planes = {}
    for q, off in enumerate(offs):
        for lv, hit in enumerate(hits_at(off)):
            k, p_ = (v[q * P + lv * L:q * P + (lv + 1) * L] for v in (vis_k, vis_p))
            planes[f"level{lv}" if len(offs) == 1 else f"s{q}_level{lv}"] = dict(
                hit_share=float(hit.float().mean()),
                on_hits=bool(torch.equal(k[:, hit], p_[:, hit])),
                zero_elsewhere=not bool(k[:, ~hit].any()))
    return planes


def _flat_rows(scene, start, cfg, plain_tol=1e-2):
    """Rows 2, 1 and 3 (`render_fused`, `loss_grad_fused`, autograd of
    `render`) at ``cfg`` from ``start``, by the rules phases mirror and
    texture share: row 2 bit for bit `render_fused_plain` (the image; each
    subsample's planes of each level on the pixels it hit, `fused.level_hits`
    at the subsample's offset, and 0 elsewhere);
    row 1 given row 2's image of the truth ``scene`` a loss and gradient of
    exactly 0, and against autograd and its eager twin (the loss within 1e-4
    relative, every leaf within 1e-2 of its scale); row 3 against autograd
    of the plain render and its twin for a unit normal cotangent, its mse
    gradient row 1's bit for bit; each one wrapper launch a call, two calls
    bit-identical. With ``plain_tol`` below 1e-2, rows 1 and 3 are held to
    autograd of the plain version within it (`_check_grads` with the float64
    plain version). Returns (rows, ok, what the callers read further: the
    target, the cotangent, row 1's gradient)."""
    from types import SimpleNamespace

    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten
    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render

    H, W, L = cfg.height, cfg.width, scene.lights.count
    rows, oks = {}, []

    # ---- row 2: the image and each subsample's planes of each level
    before = fused.FUSED_RENDER.launches
    img_k, vis_k = fused.render_fused(start, cfg)
    per_call = fused.FUSED_RENDER.launches - before
    img_2, vis_2 = fused.render_fused(start, cfg)
    img_p, vis_p = fused.render_fused_plain(start, cfg)
    torch.cuda.synchronize()
    planes = _level_planes(vis_k, vis_p, L, cfg, lambda off: fused.level_hits(start, cfg, off))
    r = dict(wrapper_launches_per_call=per_call, planes=planes,
             max_abs_err=float((img_k - img_p).abs().max()),
             image_bit_identical=bool(torch.equal(img_k, img_p)),
             deterministic=bool(torch.equal(img_k, img_2) and torch.equal(vis_k, vis_2)),
             finite=bool(torch.isfinite(img_k).all()))
    rows["fused_render"] = r
    oks.append(r["image_bit_identical"] and r["deterministic"] and r["finite"] and per_call == 1
               and tuple(vis_k.shape) == (fused.n_vis_planes(start, cfg), H, W)
               and all(v["on_hits"] and v["zero_elsewhere"] for v in planes.values()))

    # ---- row 1: zero against row 2's own image, then against autograd and the twin
    target = fused.render_fused(scene, cfg)[0]
    l_0, g_0 = fused.loss_grad_fused(scene, cfg, target)
    before = fused.FUSED_STEP.launches
    l_k, g_k = fused.loss_grad_fused(start, cfg, target)
    per_call = fused.FUSED_STEP.launches - before
    l_2, g_2 = fused.loss_grad_fused(start, cfg, target)
    r = dict(wrapper_launches_per_call=per_call, loss=float(l_k),
             zero_residual_exact=bool(float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()),
             deterministic=bool(torch.equal(
                 torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                 torch.cat([l_2.reshape(1), fused.flatten_scene(g_2)]))))
    ok = r["zero_residual_exact"] and r["deterministic"] and per_call == 1
    tight = plain_tol < 1e-2
    for name, ref in (("autograd", fused.loss_grad_fused_plain),
                      ("adjoint_eager", fused.loss_grad_adjoint_eager)):
        l_r, g_r = ref(start, cfg, target)
        rel = abs(float(l_k) - float(l_r)) / max(abs(float(l_r)), 1e-12)
        plain = name == "autograd"
        exact = (lambda: ref(_f64(start), cfg, target)[1]) if plain and tight else None
        ok = _check_grads(r, name, g_r, g_k, plain_tol if plain else 1e-2, exact) and ok \
            and rel <= 1e-4
        r[name]["loss_rel"] = rel
    r["max_abs_err"] = r["autograd"]["max_abs_err"]
    rows["fused_step"] = r
    oks.append(ok)

    # ---- row 3 by autograd of `render`: against autograd of the plain render and
    # the twin for a unit normal cotangent; its mse gradient row 1's bit for bit
    g = _seeded_cotangent(cfg)
    before = fused.FUSED_RENDER_BWD.launches
    got = _bwd(start, cfg, g)
    per_call = fused.FUSED_RENDER_BWD.launches - before
    again = _bwd(start, cfg, g)
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    by_step = fused.flatten_scene(loss_and_grad_fn(start, cfg)(start, target)[1])
    r = dict(wrapper_launches_per_call=per_call,
             deterministic=bool(torch.equal(fused.flatten_scene(got), fused.flatten_scene(again))),
             mse_bit_equal_to_row1=bool(torch.equal(by_render, by_step)),
             mse_max_abs_diff_to_row1=float((by_render - by_step).abs().max()))
    ok = _check_grads(r, "plain", fused.render_fused_bwd_plain(start, cfg, g), got, plain_tol,
                      (lambda: fused.render_fused_bwd_plain(_f64(start), cfg, g))
                      if tight else None)
    ok = _check_grads(r, "twin", fused.render_bwd_adjoint_eager(start, cfg, g, vis_k), got) and ok
    r["max_abs_err"] = r["plain"]["max_abs_err"]
    rows["fused_render_bwd"] = r
    oks.append(ok and r["deterministic"] and r["mse_bit_equal_to_row1"] and per_call == 1)
    return rows, all(oks), SimpleNamespace(target=target, g=g, grads=g_k)


def _flat_times(rows, start, cfg, target, g, bounds, case):
    """Each row's event time, device time and launches per call on the C
    entries that the wrappers launch (`fused.instance`'s ``_band`` entries,
    over the whole image), its plain version's time and its ``bounds`` into
    ``rows``; returns (the kernels line's numbers, one device launch a call
    for each)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    flat = fused._cuda_flat(start, cfg)
    geom = fused._geometry(start, cfg)
    sfx, args, ssfx, sargs = fused.instance(start, cfg)
    H, W = cfg.height, cfg.width
    stream = torch.cuda.current_stream().cuda_stream
    img = torch.empty((H, W, 3), device="cuda")
    vis = torch.empty((fused.n_vis_planes(start, cfg), H, W), device="cuda")
    scratch = torch.empty((getattr(fused.FUSED_STEP.lib(), f"rrt_step{ssfx}_scratch_floats")(
        *geom[:5], *sargs),), device="cuda")
    out = torch.empty((1 + flat.numel(),), device="cuda")
    geom += fused.band_args(cfg)  # the wrappers' ``_band`` entries, over the whole image
    calls = {
        "fused_render": lambda: fused.FUSED_RENDER.call(
            f"rrt_render{sfx}_band", flat.data_ptr(), *geom, *args, img.data_ptr(),
            vis.data_ptr(), stream),
        "fused_step": lambda: fused.FUSED_STEP.call(
            f"rrt_step{sfx}_band", flat.data_ptr(), *geom, *args, target.data_ptr(),
            1.0 / (H * W * 3), scratch.data_ptr(), out.data_ptr(), stream),
        "fused_render_bwd": lambda: fused.FUSED_RENDER_BWD.call(
            f"rrt_render_bwd{sfx}_band", flat.data_ptr(), *geom, *args, g.data_ptr(),
            vis.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)}
    calls["fused_render"]()
    plain = {"fused_render": lambda: fused.render_fused_plain(start, cfg),
             "fused_step": lambda: fused.loss_grad_fused_plain(start, cfg, target),
             "fused_render_bwd": lambda: fused.render_fused_bwd_plain(start, cfg, g)}
    numbers, ok = {}, True
    for name, fn in calls.items():
        dev = device_ms(fn)
        rows[name].update(ms=time_ms(fn), device_ms=dev["ms"], launches_per_call=dev["launches"],
                          device=dev, plain_ms=time_ms(plain[name], reps=5, warmup=1),
                          bound_ms=bounds[name][0], bound_by=bounds[name][1])
        ok = ok and dev["launches"] == 1
        numbers[name] = dict(case=case, **{
            k: rows[name][k] for k in ("ms", "device_ms", "launches_per_call",
                                      "wrapper_launches_per_call", "max_abs_err", "plain_ms",
                                      "bound_ms", "bound_by")})
    return numbers, ok


def phase_mirror():
    """Rows 1-3 with one bounce level at config 6 512^2 (see the module's
    docstring, phase 24). Returns each row's numbers."""
    import dataclasses

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import fused

    saved = {k.name: k.launches for k in _all_kernels()}
    scene, spec, cfg, start = _mirror_case()
    rows, ok, got = _flat_rows(scene, start, cfg)
    rows["fused_render"]["bounce_changes_image"] = float((fused.render_fused(start, cfg)[0] - (
        fused.render_fused(start, dataclasses.replace(cfg, reflections=0))[0])).abs().max())
    # the diffuse sphere's coefficient at 0 (the true scene) against row 2's image of
    # perturb seed 1, where it is 0.246: a gradient from the bounce traced where m = 0
    up = configs.perturb(scene, spec, scale=0.3, seed=1)
    target_up = fused.render_fused(up, cfg)[0]
    g_u = fused.loss_grad_fused(scene, cfg, target_up)[1].spheres.material.mirror[1]
    g_up = fused.loss_grad_fused_plain(scene, cfg, target_up)[1].spheres.material.mirror[1]
    rows["fused_step"]["diffuse_mirror_from_0"] = dict(
        start=float(scene.spheres.material.mirror[1]), target=float(up.spheres.material.mirror[1]),
        grad=float(g_u), autograd=float(g_up))
    ok = ok and float(g_u) < 0.0 and abs(float(g_u - g_up)) <= 1e-2 * abs(float(g_up))
    c = bounce_counts(start, cfg)
    bounds = mirror_bounds(c, fused.flatten_scene(start).numel(), 2 * scene.lights.count)
    numbers, timed = _flat_times(rows, start, cfg, got.target, got.g, bounds,
                                 f"config6_{MIRROR_SIZE}")
    for k in _all_kernels():
        k.launches = saved[k.name]
    rows["work"] = c
    if not (ok and timed):
        raise AssertionError(f"a kernel with a bounce level failed a check: {rows}")
    emit("mirror", ok=True, rows=rows)
    return numbers


def _counted(fn):
    """(fn's result, each kernel's launches in it, its wall seconds): the
    counters set to 0 just before and read just after, the card
    synchronized."""
    import time

    import torch

    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, {k.name: k.launches for k in _all_kernels()}, time.perf_counter() - t0


def _only(launches, expect):
    """Every kernel launched as often as ``expect`` says, the others never."""
    return all(n == expect.get(name, 0) for name, n in launches.items())


def _refusals(cases, rows):
    """Run each (label, CLI argv, the refusal's words, launches expected)
    case into ``rows``; whether each raised NotImplementedError by name and
    launched only what was expected (the target's render)."""
    from reversible_raytracer_tpu_torch import cli

    ok = True
    for label, argv, why, expect in cases:
        def refused(argv=argv):
            try:
                cli.main(argv)
            except NotImplementedError as exc:
                return str(exc)
            return ""
        msg, launches, _ = _counted(refused)
        rows[label] = dict(refusal=msg, launches=launches)
        ok = ok and why in msg and _only(launches, expect)
    return ok


MIRROR_ITERS = 150
MIRROR_RUNS = (("invert_512", 512), ("invert_48", 48))
MIRROR_GRAD_ITERS = 20


def phase_mirror_main():
    """The CLI and `optimize(render_fn=render)` on config 6 (see the
    module's docstring, phase 25). Returns each run's launch counts."""
    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize, param_error
    from reversible_raytracer_tpu_torch.ops.render import render

    out_dir = REPO / "smoke_out"
    rows, counts, oks = {}, {}, []

    png = out_dir / "render_config6.png"
    _, launches, wall = _counted(lambda: cli.main(["render", "--config", "6", "-o", str(png)]))
    rows["render_config6"] = dict(launches=launches, wall_seconds=wall)
    oks.append(_only(launches, {"fused_render": 1}) and png.exists())

    for label, size in MIRROR_RUNS:
        png = out_dir / f"final_mirror_{label}.png"
        argv = ["invert", "--config", "6", "--size", str(size), "--perturb", "0.3", "--lr", "2e-2",
                "--iters", str(MIRROR_ITERS), "--seed", "3", "--log-every", "1", "--quiet",
                "-o", str(png)]
        summary, launches, wall = _counted(lambda: cli.main(argv))
        hist = summary["history"]
        expect = {"fused_step": MIRROR_ITERS, "fused_render": 2}
        row = dict(launches=launches, expected=expect, first_loss=hist[0]["loss"],
                   final_loss=hist[-1]["loss"], start_param_err=hist[0]["param_err"],
                   param_err=summary["param_err"], loop_seconds=summary["seconds"],
                   loop_ms_per_step=summary["seconds"] * 1e3 / MIRROR_ITERS, wall_seconds=wall)
        rows[label] = row
        counts[label] = launches
        oks.append(_only(launches, expect) and row["param_err"] < 1e-3
                   and row["final_loss"] < row["first_loss"] and png.exists())

    scene, spec, cfg, _ = _mirror_case()

    def by_render():
        target = render(scene, cfg)
        start = _mirror_case()[3]
        final, _, losses = optimize(start, target, spec, cfg,
                                    OptConfig(iters=MIRROR_GRAD_ITERS, lr=2e-2), log_every=0,
                                    render_fn=lambda s: render(s, cfg))
        return start, final, losses.cpu().tolist()

    (start, final, la), launches, wall = _counted(by_render)
    expect = {"fused_render": MIRROR_GRAD_ITERS + 1, "fused_render_bwd": MIRROR_GRAD_ITERS}
    rows["render_fn_512"] = dict(launches=launches, expected=expect, first_loss=la[0],
                                 final_loss=la[-1],
                                 start_param_err=float(param_error(start, scene, spec)),
                                 param_err=float(param_error(final, scene, spec)),
                                 wall_seconds=wall)
    counts["render_fn_512"] = launches
    oks.append(_only(launches, expect) and la[-1] < la[0] and all(math.isfinite(x) for x in la))

    oks.append(_refusals((
        ("render_config5_four_bounces", ["render", "--config", "5", "--size", "64",
                                         "--reflections", "4", "-o", str(out_dir / "refused.png")],
         "reflections > 3", {}),
        ("invert_config6_anneal", ["invert", "--config", "6", "--size", "64", "--anneal",
                                   "0.05,0", "--iters", "2", "--quiet"],
         "mirror reflections require hard semantics", {"fused_render": 1})), rows))
    if not all(oks):
        raise AssertionError(f"a config-6 run did not run through the expected kernels, did "
                             f"not recover the mirror coefficients or did not refuse: {rows}")
    emit("mirror_main", ok=True, rows=rows)
    return counts


# The texel work of rows 1-3 (object textures and the environment map,
# spp 1): a bilinear sample is its weights (u and v scaled, floored,
# clamped or wrapped, the fractions clipped: 14), its 4 texel reads (12
# floats) and the mix (29); a sphere's texture and a miss's environment add
# the lat-long coordinates (sphere_uv: the polynomial atan2 and asin, the
# clip and scales: 54). The adjoint scatters 12 weighted values and takes
# the weights' gradient (adj_tex, 50), a sphere's or a miss's coordinates'
# cotangents through atan2 and asin (adj_uv, 75), a rect's (a, b) into o, d,
# t and its edges (adj_ab, 40), and adds 12 values into the warp's row
# (sum_texel); a miss with an environment map also runs the camera's adjoint.
TEX_OPS = dict(tex_weights=14, tex_read=12, tex_mix=29, uv=54, adj_tex=50, adj_uv=75, adj_ab=40,
               sum_texel=12)
TEX_SIZE = 512
TEX_CASES = (("config7", 7), ("config8", 8), ("config9", 9))


def texel_counts(scene, cfg, off=(0.0, 0.0)):
    """The pixels that sample a texel grid in one subsample, at the offset
    ``off`` (`spp_work` sums them): level 0's winners in a textured group
    (``tex_sph``, ``tex_rect``), with bounces the bounce levels' (``tex_sph1``,
    ``tex_rect1``, where every level above hit; the levels summed), level 0's
    misses with an environment map (``env0``) and, with bounces, each bounce
    level's misses where every level above hit (``env1``, summed)."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import fused

    o, d = pl.primary_rays(scene, cfg, off)
    t, k = fused._nearest_chain(scene, o, d)
    N = scene.spheres.count
    sp_tex, rc_tex = scene.spheres.textured, scene.rects.textured
    hits = fused.level_hits(scene, cfg, off)
    env = scene.env_mapped
    c = dict(tex_sph=int((k >= 0).logical_and(k < N).sum()) if sp_tex else 0,
             tex_rect=int((k >= N).sum()) if rc_tex else 0, tex_sph1=0, tex_rect1=0,
             env0=int((~hits[0]).sum()) if env else 0,
             env1=sum(int((hits[v - 1] & ~hits[v]).sum()) for v in range(1, len(hits)))
             if env else 0)
    if sp_tex or rc_tex:
        zero = torch.zeros(cfg.shape, device=scene.device)
        for v in range(1, len(hits)):
            w = fused.winner_surface(scene, fused.winner_geometry(scene, k, zero), o, d, t, zero)
            o, d = pl.shadow_origin(o, d, t, w.n), pl.reflect_dir(d, w.n)
            t, k = fused._nearest_chain(scene, o, d)
            kv = torch.where(hits[v - 1], k, -1)
            c["tex_sph1"] += int((kv >= 0).logical_and(kv < N).sum()) if sp_tex else 0
            c["tex_rect1"] += int((kv >= N).sum()) if rc_tex else 0
    return c


def texel_ops(t, step):
    """The operations the texel samples add to a forward (``step`` False) or
    to a step or render backward (their adjoints too)."""
    sample = TEX_OPS["tex_weights"] + TEX_OPS["tex_read"] + TEX_OPS["tex_mix"]
    uv_px = t["tex_sph"] + t["tex_sph1"] + t["env0"] + t["env1"]
    n = uv_px + t["tex_rect"] + t["tex_rect1"]
    ops = n * sample + uv_px * TEX_OPS["uv"]
    if step:
        ops += (n * (TEX_OPS["adj_tex"] + TEX_OPS["sum_texel"]) + uv_px * TEX_OPS["adj_uv"]
                + (t["tex_rect"] + t["tex_rect1"]) * TEX_OPS["adj_ab"]
                + t["env0"] * OPS["adj_camera"])
    return ops


def texture_bounds(scene, cfg, S, planes):
    """Rows 2, 1 and 3's bounds on a textured scene: (ms, by) each, the
    texel work of `texel_ops` over the counts of `texel_counts`, on top of
    `work_counts` (with a bounce `bounce_counts` and its terms); at spp 4
    each subsample's counts summed (`spp_work`)."""
    c = spp_work(bounce_counts if cfg.reflections else work_counts, scene, cfg)
    t = spp_work(texel_counts, scene, cfg)
    fwd, step, bwd = render_ops(c, misses=False), step_ops(c), bwd_ops(c)
    if cfg.reflections:
        fwd += _bounce_render_ops(c)
        step += _bounce_step_ops(c)
        bwd += _bounce_step_ops(c, shadows=False)
    H, W = cfg.height, cfg.width
    return dict(
        fused_render=bound(fwd + texel_ops(t, False), 4 * (S + H * W * (3 + planes))),
        fused_step=bound(step + texel_ops(t, True), 4 * (S + H * W * 3 + 1 + S)),
        fused_render_bwd=bound(bwd + texel_ops(t, True), 4 * (S + H * W * (3 + planes) + 1 + S)),
    ), dict(c, **t)


def _texture_case(num, size=TEX_SIZE):
    from reversible_raytracer_tpu_torch.models import configs

    scene, spec, cfg = configs.CONFIGS[num](size=size, device="cuda")
    return scene, spec, cfg, configs.perturb(scene, spec, scale=0.4, seed=0)


def _texel_leaf(grads, num):
    return {7: grads.rects.texture, 8: grads.spheres.texture, 9: grads.env}[num]


def phase_texture():
    """Rows 1-3's textured instances at configs 7, 8 and 9, 512^2 (see the
    module's docstring, phase 26). Returns each row's numbers per config."""
    from reversible_raytracer_tpu_torch.ops.kernels import fused

    saved = {k.name: k.launches for k in _all_kernels()}
    rows, oks, numbers = {}, [], {}
    for label, num in TEX_CASES:
        scene, spec, cfg, start = _texture_case(num)
        case, ok, got = _flat_rows(scene, start, cfg)
        texels = _texel_leaf(got.grads, num)
        case["fused_step"]["texels_with_gradient"] = float((texels != 0).float().mean())
        S = fused.flatten_scene(start).numel()
        bounds, case["work"] = texture_bounds(start, cfg, S, fused.n_vis_planes(start, cfg))
        nums, timed = _flat_times(case, start, cfg, got.target, got.g, bounds,
                                  f"{label}_{TEX_SIZE}")
        for name, n in nums.items():
            numbers.setdefault(name, {})[n.pop("case")] = n
        case["S"] = S
        rows[label] = case
        oks.append(ok and timed and case["fused_step"]["texels_with_gradient"] > 0.05)
    for k in _all_kernels():
        k.launches = saved[k.name]
    if not all(oks):
        raise AssertionError(f"a textured instance failed a check: {rows}")
    emit("texture", ok=True, rows=rows)
    return numbers


TEX_ITERS = 200
TEX_RUNS = ((7, 0.25), (8, 0.3), (9, 0.3))  # config, the texels' error bound of its JAX test
TEX_RUN_SIZES = (512, 64)
TEX_GRAD_ITERS = 20


def observable_texels(scene, spec, cfg):
    """The texels that have a gradient at the truth towards 0.9 times its
    image (the step kernel's the dispatch takes: row 1's, or with object
    textures and a bounce row 6's; the JAX tests' mask, test_texture.py:392-393),
    as a mask of the config's trained texel leaf."""
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render

    target = render(scene, cfg) * 0.9
    grads = loss_and_grad_fn(scene, cfg)(scene, target)[1]
    for g, t in zip(tree_leaves(grads), tree_leaves(spec.trainable)):
        if t:
            return g.abs() > 1e-10
    raise ValueError("no trained leaf")


def phase_texture_main():
    """The CLI and `optimize(render_fn=render)` on configs 7, 8 and 9 (see
    the module's docstring, phase 27). Returns each run's launch counts."""
    import time

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize
    from reversible_raytracer_tpu_torch.ops.render import render

    out_dir = REPO / "smoke_out"
    rows, counts, oks = {}, {}, []
    t_phase = time.perf_counter()

    def texel_rms(scene, truth, spec, mask):
        for a, b, t in zip(tree_leaves(scene), tree_leaves(truth), tree_leaves(spec.trainable)):
            if t:
                return float(((a - b)[mask] ** 2).mean().sqrt())

    for num, frac in TEX_RUNS:
        png = out_dir / f"render_config{num}.png"
        _, launches, wall = _counted(lambda: cli.main(["render", "--config", str(num), "-o",
                                                       str(png)]))
        rows[f"render_config{num}"] = dict(launches=launches, wall_seconds=wall)
        oks.append(_only(launches, {"fused_render": 1}) and png.exists())
        for size in TEX_RUN_SIZES:
            label = f"invert_config{num}_{size}"
            png = out_dir / f"final_{label}.png"
            argv = ["invert", "--config", str(num), "--size", str(size), "--lr", "3e-2",
                    "--perturb", "0.4", "--iters", str(TEX_ITERS), "--log-every",
                    str(TEX_ITERS - 1), "--quiet", "-o", str(png)]
            summary, launches, wall = _counted(lambda: cli.main(argv))
            scene, spec, cfg = configs.CONFIGS[num](size=size, device="cuda")
            start = configs.perturb(scene, spec, scale=0.4, seed=0)
            mask = observable_texels(scene, spec, cfg)
            err0 = texel_rms(start, scene, spec, mask)
            err1 = texel_rms(summary["scene"], scene, spec, mask)
            hist = summary["history"]
            expect = {"fused_step": TEX_ITERS, "fused_render": 2}
            row = dict(launches=launches, expected=expect, first_loss=hist[0]["loss"],
                       final_loss=hist[-1]["loss"], observable_share=float(mask.float().mean()),
                       start_texel_rms=err0, texel_rms=err1, texel_rms_ratio=err1 / err0,
                       bound_ratio=frac, loop_seconds=summary["seconds"],
                       loop_ms_per_step=summary["seconds"] * 1e3 / TEX_ITERS,
                       wall_seconds=wall)
            rows[label] = row
            counts[label] = launches
            ok = (_only(launches, expect) and row["final_loss"] < row["first_loss"]
                  and png.exists())
            if size == 64:  # the JAX tests' criteria (at 64^2)
                ok = ok and row["final_loss"] < 1e-5 and err1 < frac * err0
            oks.append(ok)

    for _, num in TEX_CASES:
        scene, spec, cfg, start = _texture_case(num)

        def by_render():
            target = render(scene, cfg)
            final, _, losses = optimize(start, target, spec, cfg,
                                        OptConfig(iters=TEX_GRAD_ITERS, lr=3e-2), log_every=0,
                                        render_fn=lambda s: render(s, cfg))
            return losses.cpu().tolist()

        la, launches, wall = _counted(by_render)
        expect = {"fused_render": TEX_GRAD_ITERS + 1, "fused_render_bwd": TEX_GRAD_ITERS}
        label = f"render_fn_config{num}_{TEX_SIZE}"
        rows[label] = dict(launches=launches, expected=expect, first_loss=la[0],
                           final_loss=la[-1], wall_seconds=wall)
        counts[label] = launches
        oks.append(_only(launches, expect) and la[-1] < la[0]
                   and all(math.isfinite(x) for x in la))

    # spp 4 with a texel grid is covered: row 2 once and a PNG
    png = out_dir / "render_config7_spp4.png"
    _, launches, wall = _counted(lambda: cli.main(["render", "--config", "7", "--size", "64",
                                                   "--spp", "4", "-o", str(png)]))
    rows["render_config7_spp4"] = dict(launches=launches, wall_seconds=wall,
                                       png_bytes=png.stat().st_size if png.exists() else 0)
    oks.append(_only(launches, {"fused_render": 1}) and png.exists())
    refused = str(out_dir / "refused.png")
    oks.append(_refusals((
        ("render_config8_reflections_4", ["render", "--config", "8", "--size", "64",
                                          "--reflections", "4", "-o", refused],
         "reflections > 3", {}),
        ("render_config8_spp4_reflections_4", ["render", "--config", "8", "--size", "64",
                                               "--spp", "4", "--reflections", "4", "-o",
                                               refused], "reflections > 3", {}),
        ("invert_config7_anneal_soft_checker", ["invert", "--config", "7", "--size", "64",
                                                "--anneal", "0.05,0", "--checker-ratio", "12.5",
                                                "--iters", "2", "--quiet"],
         "the soft checker (checker_tau > 0) with a texel grid", {"fused_render": 1}),
        ("invert_config9_anneal", ["invert", "--config", "9", "--size", "64", "--anneal",
                                   "0.05,0", "--iters", "2", "--quiet"],
         "mirror reflections require hard semantics", {"fused_render": 1})), rows))
    rows["phase_seconds"] = time.perf_counter() - t_phase
    if not all(oks):
        raise AssertionError(f"a config 7-9 run did not run through the expected kernels, did "
                             f"not recover its texels or did not refuse: {rows}")
    emit("texture_main", ok=True, rows=rows)
    return counts


# The object-chunked kernels' env and bounce instances (rows 4-6; phases
# chrome and chrome_main): config 10 at 512^2 (64 chrome spheres under a
# sky, one bounce) and config 5 at 1024^2 with one bounce, from
# perturb(scale, seed) of their trained leaves.
CHROME_CASES = (("config10_512", 10, 512, 0.2, 10), ("config5r_1024", 5, 1024, 0.05, 4))


def _chrome_case(num, size, scale, seed):
    import dataclasses

    from reversible_raytracer_tpu_torch.models import configs

    scene, spec, cfg = configs.CONFIGS[num](size=size, device="cuda")
    cfg = dataclasses.replace(cfg, reflections=1)
    return scene, spec, cfg, configs.perturb(scene, spec, scale=scale, seed=seed)


def vec_bounce_counts(scene, cfg, off=(0.0, 0.0)):
    """Level 0's `work_counts(..., cull=True)`, `bounce_counts`' bounce levels
    (the reflected rays, their winners and lit pairs), the reflected rays'
    sphere tests at the per-warp cull of `cull.bounce_candidates` (a ball of
    the warp's origins, a cone of its directions): the warps with a reflected
    ray (``l1_warps``), their candidates (``l1_prim_visits``) and the (ray,
    candidate) pairs (``l1_prim_pairs``; before the cull ``l1_prim_all``,
    every sphere for every reflected ray, as rows 4-6 walk them), and the
    bounce levels' shadow culls as rows 4 and 6 run them (csrc/cull.cuh
    warp_candidates over the level's hit lanes' shadow origins): the warps
    with such a lane per light (``l1_shadow_warps``) and the sphere tests of
    the hit pixels' any-hit walks over their candidates until the first
    occluder (``l1_shadow_sph_culled``); each of the ``cfg.reflections``
    levels counted as level 1 and summed. Of one subsample, at the offset
    ``off`` (`spp_work` sums them)."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import cull as cl
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import sphere_ts

    c = work_counts(scene, dataclasses.replace(cfg, reflections=0), cull=True, off=off)
    c.update({k: v for k, v in bounce_counts(scene, cfg, off).items() if k.startswith("l1_")})
    sp, W = scene.spheres, cfg.width
    o, d = pl.primary_rays(scene, cfg, off)
    t, hit0, at = pl.trace_nearest(scene, o, d, cfg.shape)
    sums = dict(l1_warps=0, l1_prim_visits=0, l1_prim_pairs=0, l1_prim_all=0,
                l1_shadow_warps=0, l1_shadow_sph_culled=0)
    for _ in range(cfg.reflections):
        n = (at["nx"], at["ny"], at["nz"])
        o1, d1 = pl.shadow_origin(o, d, t, n), pl.reflect_dir(d, n)
        t1, hit1, at1 = pl.trace_nearest(scene, o1, d1, cfg.shape)
        live = hit0 & hit1
        so1 = pl.shadow_origin(o1, d1, t1, (at1["nx"], at1["ny"], at1["nz"]))
        warps, tests = 0, 0
        with torch.no_grad():
            rays = cl.runs(hit0, False).sum(-1)
            n_b = cl.bounce_candidates(sp, o1, d1, hit0).sum(-1)  # (H, R)
            sums["l1_warps"] += int((rays > 0).sum())
            sums["l1_prim_visits"] += int(n_b.sum())
            sums["l1_prim_pairs"] += int((n_b * rays).sum())
            sums["l1_prim_all"] += int(hit0.sum()) * sp.count
            lanes = cl.runs(live, False).sum(-1)
            for li in range(scene.lights.count if cfg.shadows else 0):
                ldir, dist = pl.light_geometry(scene.lights, li, so1)
                keep = cl.per_pixel(cl.warp_candidates(sp, so1, live, scene.lights.position[li],
                                                       0.0), W)
                occ = (sphere_ts(sp, so1, ldir) < dist[None]) & keep
                visited = torch.cumsum(keep, 0, dtype=torch.int16)
                first = occ.to(torch.uint8).argmax(0)
                tests_px = torch.where(occ.any(0), visited.gather(0, first[None])[0],
                                       visited[-1])
                warps += int((lanes > 0).sum())
                tests += int(tests_px[live].sum())
                del occ, visited, keep
        sums["l1_shadow_warps"] += warps
        sums["l1_shadow_sph_culled"] += tests
        o, d, t, hit0, at = o1, d1, t1, live, at1
    c.update(sums)
    return c


def _vec_bounce_ops(c, step, shadows=True, cull=True):
    """Rows 4-6's level-1 operations: `_bounce_render_ops` (the reflected
    rays' walk over every object, their shading and the blend), with
    ``cull`` the reflected rays' sphere tests at `cull.bounce_candidates`
    (per warp with a reflected ray its cone and ball; per (warp, sphere) the
    sphere's distance and widened radius from the ball's centre and the cone
    test; per (ray, candidate) the sphere test) in place of the walk over
    every sphere, level 1's culled shadow walks where the row casts shadow
    rays (per warp with a level-1 hit lane and sphere the segment test, the
    hit pixels' sphere tests until the first occluder, the rects'), and in a
    step or backward `_bounce_step_ops`' adjoints."""
    ops = _bounce_render_ops(c)
    if cull:
        ops += (c["l1_warps"] * (CULL_OPS["cone_warp"]
                                 + c["n_sph"] * (CULL_OPS["cone_sphere"] + CULL_OPS["cone_test"]))
                + (c["l1_prim_pairs"] - c["l1_prim_all"]) * OPS["sphere_shadow"])
    if shadows:
        ops += (c["l1_shadow_warps"] * c["n_sph"] * SOFT_OPS["warp_test"]
                + c["l1_shadow_sph_culled"] * OPS["sphere_shadow"]
                + c["l1_shadow_rect"] * OPS["rect_shadow"])
    if step:
        ops += _bounce_step_ops(c, shadows=False) - _bounce_render_ops(c)
    return ops


def chrome_bounds(scene, cfg, Sg, planes):
    """Rows 4, 6 and 5's bounds in their env, bounce and textured instances:
    (ms, by) each, the culled level 0 (`render_ops`, `step_ops`, `bwd_ops`
    with ``cull``), with a bounce the culled level 1 (`_vec_bounce_ops` over
    `vec_bounce_counts`), and the env's and the object texels' samples
    (`texel_ops` over `texel_counts`; the object grids read once and their
    gradient written once); the same before the culls (every sphere at both
    levels); and the counts (at spp 4 each subsample's summed, `spp_work`)."""
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec

    c = (spp_work(vec_bounce_counts, scene, cfg) if cfg.reflections
         else dict(spp_work(lambda s, c1, off: work_counts(s, c1, cull=True, off=off), scene,
                            cfg), l1_rays=0))
    t = spp_work(texel_counts, scene, cfg)
    ns_pad, nr_pad = fused_vec.row_plan(scene)
    H, W = cfg.height, cfg.width
    tex = 4 * fused_vec.texel_row(scene)  # object texels: read once, their gradient written once
    rows = 4 * (Sg + ns_pad * 17 + nr_pad * 22)
    nbytes = dict(fused_vec_render=rows + tex + 4 * H * W * (3 + planes),
                  fused_vec_step=vec_step_bytes(H * W, Sg, ns_pad, nr_pad) + 2 * tex,
                  fused_vec_render_bwd=vec_step_bytes(H * W, Sg, ns_pad, nr_pad, planes)
                  + 2 * tex)

    def level1(step, shadows=True, cull=True):
        return _vec_bounce_ops(c, step, shadows, cull) if cfg.reflections else 0

    def bounds(cull):
        return dict(
            fused_vec_render=render_ops(c, cull=cull) + level1(False, cull=cull)
            + texel_ops(t, False),
            fused_vec_step=step_ops(c, cull=cull) + level1(True, cull=cull) + texel_ops(t, True),
            fused_vec_render_bwd=bwd_ops(c, cull=cull) + level1(True, False, cull)
            + texel_ops(t, True))

    culled, full = bounds(True), bounds(False)
    return ({k: bound(v, nbytes[k]) for k, v in culled.items()},
            {k: bound(v, nbytes[k]) for k, v in full.items()}, dict(c, **t))


def _vec_rows(scene, start, cfg, plain_tol=1e-2):
    """Rows 4, 6 and 5 (`render_vec`, `loss_grad_vec`, autograd of `render`)
    at ``cfg`` from ``start``, by the rules of phase chrome: row 4 by the
    oracle rule against `render_vec_plain` and bit for bit (the image; each
    subsample's planes of each level on the pixels it hit,
    `fused_vec.level_hits` at its offset, 0 elsewhere); row
    6 given row 4's image of the truth ``scene`` a loss and gradient of
    exactly 0, and against autograd and its eager twin (the loss within 1e-4
    relative, every leaf within 1e-2 of its scale); row 5 against autograd
    of the plain render and its twin for a unit normal cotangent, its mse
    gradient row 6's bit for bit (at spp 4, where autograd adds row 5's four
    launches, within 1e-4 of each leaf's scale); each one wrapper launch a
    call (rows 4 and 5 one a subsample), three calls bit-identical. With
    ``plain_tol`` below 1e-2, rows 6 and 5 are held to autograd of the plain
    version within it (`_check_grads` with the float64 plain version).
    Returns (rows, ok, what the callers read further: the target, the
    cotangent, row 4's planes)."""
    from types import SimpleNamespace

    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render

    H, W, L = cfg.height, cfg.width, scene.lights.count
    rows, oks = {}, []
    flat = lambda loss, g: torch.cat([loss.reshape(1), fused.flatten_scene(g)])  # noqa: E731
    subs = cfg.spp  # rows 4 and 5 launch once a subsample

    # ---- row 4: the image and each subsample's planes of each level
    before = fused_vec.VEC_RENDER.launches
    img_k, vis_k = fused_vec.render_vec(start, cfg)
    per_call = fused_vec.VEC_RENDER.launches - before
    again = [fused_vec.render_vec(start, cfg) for _ in range(2)]
    img_p, vis_p = fused_vec.render_vec_plain(start, cfg)
    torch.cuda.synchronize()
    err = (img_k - img_p).abs()
    planes = _level_planes(vis_k, vis_p, L, cfg,
                           lambda off: fused_vec.level_hits(start, cfg, off))
    r = dict(wrapper_launches_per_call=per_call, planes=planes,
             frac_bad=float((err > 2e-3).float().mean()), mean_err=float(err.mean()),
             max_abs_err=float(err.max()), image_bit_identical=bool(torch.equal(img_k, img_p)),
             deterministic=all(torch.equal(img_k, a) and torch.equal(vis_k, b) for a, b in again),
             finite=bool(torch.isfinite(img_k).all()))
    rows["fused_vec_render"] = r
    oks.append(r["frac_bad"] < 1e-3 and r["mean_err"] < 1e-4 and r["image_bit_identical"]
               and r["deterministic"] and r["finite"] and per_call == subs
               and tuple(vis_k.shape) == (fused_vec.n_vis_planes(start, cfg), H, W)
               and all(v["on_hits"] and v["zero_elsewhere"] for v in planes.values()))

    # ---- row 6: zero against row 4's own image, then against autograd and the twin
    target = fused_vec.render_vec(scene, cfg)[0]
    l_0, g_0 = fused_vec.loss_grad_vec(scene, cfg, target)
    before = fused_vec.VEC_STEP.launches
    l_k, g_k = fused_vec.loss_grad_vec(start, cfg, target)
    per_call = fused_vec.VEC_STEP.launches - before
    again = [flat(*fused_vec.loss_grad_vec(start, cfg, target)) for _ in range(2)]
    r = dict(wrapper_launches_per_call=per_call, loss=float(l_k),
             zero_residual_exact=bool(float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()),
             deterministic=all(torch.equal(flat(l_k, g_k), a) for a in again),
             mirror_grad_nonzero=float((torch.cat([g_k.spheres.material.mirror,
                                                   g_k.rects.material.mirror]) != 0)
                                       .float().mean()),
             env_grad_nonzero=float((g_k.env != 0).float().mean()) if start.env_mapped else None,
             texel_grad_nonzero=_texel_share(start, g_k))
    ok = r["zero_residual_exact"] and r["deterministic"] and per_call == 1
    tight = plain_tol < 1e-2
    for name, ref in (("autograd", fused_vec.loss_grad_vec_plain),
                      ("adjoint_eager", fused_vec.loss_grad_vec_adjoint_eager)):
        l_r, g_r = ref(start, cfg, target)
        rel = abs(float(l_k) - float(l_r)) / max(abs(float(l_r)), 1e-12)
        plain = name == "autograd"
        exact = (lambda: ref(_f64(start), cfg, target)[1]) if plain and tight else None
        ok = _check_grads(r, name, g_r, g_k, plain_tol if plain else 1e-2, exact) and ok \
            and rel <= 1e-4
        r[name]["loss_rel"] = rel
    r["max_abs_err"] = r["autograd"]["max_abs_err"]
    rows["fused_vec_step"] = r
    oks.append(ok and (r["mirror_grad_nonzero"] > 0 or not cfg.reflections)
               and (r["texel_grad_nonzero"] is None or r["texel_grad_nonzero"] > 0))

    # ---- row 5 by autograd of `render`: against autograd of the plain render and
    # the twin for a unit normal cotangent; its mse gradient row 6's bit for bit
    g = _seeded_cotangent(cfg)
    before = fused_vec.VEC_RENDER_BWD.launches
    got = _bwd(start, cfg, g)
    per_call = fused_vec.VEC_RENDER_BWD.launches - before
    again = [fused.flatten_scene(_bwd(start, cfg, g)) for _ in range(2)]
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    by_step = fused.flatten_scene(loss_and_grad_fn(start, cfg)(start, target)[1])
    r = dict(wrapper_launches_per_call=per_call,
             deterministic=all(torch.equal(fused.flatten_scene(got), a) for a in again),
             texel_grad_nonzero=_texel_share(start, got),
             mse_bit_equal_to_row6=bool(torch.equal(by_render, by_step)),
             mse_max_abs_diff_to_row6=float((by_render - by_step).abs().max()))
    # at spp 4 autograd adds the four launches' gradients, where row 6 sums the
    # subsamples in its own order: the same up to that order, not to the bit
    r["mse_worst_to_row6"] = max(_grad_errors(fused.unflatten_scene(start, by_step),
                                              fused.unflatten_scene(start, by_render)).values())
    mse_ok = r["mse_bit_equal_to_row6"] if subs == 1 else r["mse_worst_to_row6"] <= 1e-4
    ok = _check_grads(r, "plain", fused_vec.render_vec_bwd_plain(start, cfg, g), got, plain_tol,
                      (lambda: fused_vec.render_vec_bwd_plain(_f64(start), cfg, g))
                      if tight else None)
    ok = _check_grads(r, "twin", fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g, vis_k),
                      got) and ok
    r["max_abs_err"] = r["plain"]["max_abs_err"]
    rows["fused_vec_render_bwd"] = r
    oks.append(ok and r["deterministic"] and mse_ok and per_call == subs
               and (r["texel_grad_nonzero"] is None or r["texel_grad_nonzero"] > 0))
    return rows, all(oks), SimpleNamespace(target=target, g=g, vis=vis_k)


def _texel_share(scene, grads):
    """The share of the object texels whose gradient is not 0 (None for a
    scene without object texel grids)."""
    import torch

    if not (scene.spheres.textured or scene.rects.textured):
        return None
    g = torch.cat([grads.spheres.texture.reshape(-1), grads.rects.texture.reshape(-1)])
    return float((g != 0).float().mean())


# One timed call of each plain version in phases chrome and globes (warm from
# their checks): at 512^2 and 64 textured spheres one takes 0.1-0.2 s.
VEC_PLAIN_REPS = dict(reps=1, warmup=0)


def _vec_times(rows, start, cfg, target, g, vis, bounds, case, uncull):
    """Rows 4, 6 and 5's event time, device time and launches per call on
    the ``_band`` C entries the wrappers launch, over the whole image (the
    ``_levels`` entries, with object texel grids the ``_tex`` ones; at spp
    4 rows 4 and 5 once a subsample at its offsets, into and from its
    planes), the plain versions' times,
    ``bounds`` and the bounds before the culls ``uncull`` into ``rows``;
    returns the kernels line's numbers."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
    from reversible_raytracer_tpu_torch.ops.pipeline import SPP_OFFSETS

    glob, sph, rct = fused_vec._cuda_inputs(start, cfg)
    geom = fused_vec._geometry(start, cfg) + fused.band_args(cfg)
    H, W = cfg.height, cfg.width
    stream = torch.cuda.current_stream().cuda_stream
    img = torch.empty((H, W, 3), device="cuda")
    planes = torch.empty_like(vis)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel()
                       + fused_vec.texel_row(start),), device="cuda")
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr())
    if fused_vec.object_textured(start):
        tex = fused_vec.texel_inputs(start)
        ptrs += tuple(t.data_ptr() for t in tex)
        sfx, lv = "_tex", fused_vec.tex_levels(start, cfg)
        scratch = torch.empty((fused_vec.VEC_STEP.lib().rrt_vec_step_tex_scratch_floats(
            geom[0], geom[1], *geom[4:7], *lv[1:]),), device="cuda")
    else:
        sfx, lv = "_levels", fused_vec.levels(start, cfg)
        scratch = torch.empty((fused_vec.VEC_STEP.lib().rrt_vec_step_levels_scratch_floats(
            *geom[2:7], lv[1]),), device="cuda")
    ptrs += tuple(geom)
    offs = SPP_OFFSETS[cfg.spp]
    P = vis.shape[0] // len(offs)  # a subsample's planes

    def render_calls():
        for q, off in enumerate(offs):
            fused_vec.VEC_RENDER.call(f"rrt_vec_render{sfx}_band", *ptrs, *off, *lv,
                                      img.data_ptr(), planes[q * P:].data_ptr(), stream)

    def bwd_calls():
        for q, off in enumerate(offs):
            fused_vec.VEC_RENDER_BWD.call(f"rrt_vec_render_bwd{sfx}_band", *ptrs, *off, *lv,
                                          g.data_ptr(), vis[q * P:].data_ptr(),
                                          scratch.data_ptr(), out.data_ptr(), stream)

    calls = {
        "fused_vec_render": render_calls,
        "fused_vec_step": lambda: fused_vec.VEC_STEP.call(
            f"rrt_vec_step{sfx}_band", *ptrs, cfg.spp, *lv, target.data_ptr(),
            1.0 / (H * W * 3), scratch.data_ptr(), out.data_ptr(), stream),
        "fused_vec_render_bwd": bwd_calls}
    plain = {"fused_vec_render": lambda: fused_vec.render_vec_plain(start, cfg),
             "fused_vec_step": lambda: fused_vec.loss_grad_vec_plain(start, cfg, target),
             "fused_vec_render_bwd": lambda: fused_vec.render_vec_bwd_plain(start, cfg, g)}
    numbers = {}
    for name, fn in calls.items():
        dev = device_ms(fn)
        rows[name].update(ms=time_ms(fn), device_ms=dev["ms"], launches_per_call=dev["launches"],
                          device=dev, plain_ms=time_ms(plain[name], **VEC_PLAIN_REPS),
                          bound_ms=bounds[name][0], bound_by=bounds[name][1],
                          bound_uncull_ms=uncull[name][0])
        numbers[name] = dict(case=case, **{
            k: rows[name][k] for k in ("ms", "device_ms", "launches_per_call",
                                      "wrapper_launches_per_call", "max_abs_err", "plain_ms",
                                      "bound_ms", "bound_by", "bound_uncull_ms")})
    return numbers


def phase_chrome():
    """Rows 4-6's env and bounce instances at config 10 512^2 and config 5
    1024^2 with one bounce (see the module's docstring, phase 28). Returns
    each row's numbers per case."""
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec

    saved = {k.name: k.launches for k in _all_kernels()}
    rows, oks, numbers = {}, [], {}
    for label, num, size, scale, seed in CHROME_CASES:
        scene, spec, cfg, start = _chrome_case(num, size, scale, seed)
        case, ok, got = _vec_rows(scene, start, cfg)
        Sg = fused_vec.flatten_globals(start).numel()
        bounds, uncull, case["work"] = chrome_bounds(start, cfg, Sg,
                                                     fused_vec.n_vis_planes(start, cfg))
        nums = _vec_times(case, start, cfg, got.target, got.g, got.vis, bounds, label, uncull)
        for name, n in nums.items():
            numbers.setdefault(name, {})[n.pop("case")] = n
        case["Sg"] = Sg
        case["most_spheres"] = dict(
            step=fused_vec.most_spheres(1, 1, fused_vec.levels(start, cfg)[1]),
            render=fused_vec.most_render_spheres(1, 1, *fused_vec.levels(start, cfg)))
        rows[label] = case
        oks.append(ok)
    for k in _all_kernels():
        k.launches = saved[k.name]
    if not all(oks):
        raise AssertionError(f"an env or bounce instance of rows 4-6 failed a check: {rows}")
    emit("chrome", ok=True, rows=rows)
    return numbers


CHROME_ITERS = 300  # scripts/config10_check.py: --perturb 0.2 --lr 2e-2 --iters 300, cosine
CHROME_SMALL = dict(size=48, iters=60, lr="2e-2", perturb="0.25", seed="0")  # tests/test_env.py
CHROME_GRAD_ITERS = 20
CHROME_C5_ITERS = 20


def _render_fn_losses(scene, spec, cfg, scale, seed, lr):
    """The losses of `CHROME_GRAD_ITERS` steps of `optimize(render_fn=render)`
    (rows 4 + 5) at the learning rate ``lr`` from perturb(scale, seed) of
    ``scene`` toward its render."""
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize
    from reversible_raytracer_tpu_torch.ops.render import render

    start = configs.perturb(scene, spec, scale=scale, seed=seed)
    target = render(scene, cfg)
    _, _, losses = optimize(start, target, spec, cfg, OptConfig(iters=CHROME_GRAD_ITERS, lr=lr),
                            log_every=0, render_fn=lambda s: render(s, cfg))
    return losses.cpu().tolist()


def phase_chrome_main():
    """The CLI and `optimize(render_fn=render)` on config 10, and config 5
    with one bounce (see the module's docstring, phase 29). Returns each
    run's launch counts."""
    import dataclasses
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.optim import param_error
    from reversible_raytracer_tpu_torch.ops.render import render

    out_dir = REPO / "smoke_out"
    rows, counts, oks = {}, {}, []
    t_phase = time.perf_counter()

    png = out_dir / "render_config10.png"
    _, launches, wall = _counted(lambda: cli.main(["render", "--config", "10", "-o", str(png)]))
    rows["render_config10"] = dict(launches=launches, wall_seconds=wall)
    oks.append(_only(launches, {"fused_vec_render": 1}) and png.exists())

    # ---- the JAX recipe at 512^2: the mirror coefficients and the sky's texels
    scene, spec, cfg = configs.config10_chrome_field(size=512, device="cuda")
    ones = torch.ones((cfg.height, cfg.width, 3), device="cuda")
    obs = (fused.autograd_vjp(render, scene, cfg, ones).env.abs() > 0.0).any(-1)  # (K, K)

    def split(s):
        mir = float(((s.spheres.material.mirror - scene.spheres.material.mirror) ** 2)
                    .mean().sqrt())
        d2 = ((s.env - scene.env) ** 2).mean(-1)
        return mir, float(d2[obs].mean().sqrt()), float(d2[~obs].mean().sqrt())

    png = out_dir / "final_config10_512.png"
    argv = ["invert", "--config", "10", "--perturb", "0.2", "--lr", "2e-2", "--iters",
            str(CHROME_ITERS), "--seed", "10", "--log-every", str(CHROME_ITERS - 1), "--quiet",
            "-o", str(png)]
    summary, launches, wall = _counted(lambda: cli.main(argv))
    start = configs.perturb(scene, spec, scale=0.2, seed=10)
    (m0, e0, u0), (m1, e1, u1) = split(start), split(summary["scene"])
    hist = summary["history"]
    expect = {"fused_vec_step": CHROME_ITERS, "fused_vec_render": 2}
    row = dict(launches=launches, expected=expect, first_loss=hist[0]["loss"],
               final_loss=hist[-1]["loss"], observable_share=float(obs.float().mean()),
               mirror_rms_start=m0, mirror_rms=m1, env_rms_observable_start=e0,
               env_rms_observable=e1, env_rms_observable_ratio=e1 / e0,
               env_rms_unobservable_start=u0, env_rms_unobservable=u1,
               unobservable_unchanged=bool(torch.equal(summary["scene"].env[~obs],
                                                       start.env[~obs])),
               loop_seconds=summary["seconds"],
               loop_ms_per_step=summary["seconds"] * 1e3 / CHROME_ITERS, wall_seconds=wall)
    rows["invert_config10_512"] = row
    counts["invert_config10_512"] = launches
    oks.append(_only(launches, expect) and row["final_loss"] < row["first_loss"] and m1 < 1e-3
               and e1 < 0.05 * e0 and row["unobservable_unchanged"] and png.exists())

    # ---- the JAX test's run at 48^2 (tests/test_env.py:335-358)
    small, sspec, _ = configs.config10_chrome_field(size=CHROME_SMALL["size"], device="cuda")
    argv = ["invert", "--config", "10", "--size", str(CHROME_SMALL["size"]), "--iters",
            str(CHROME_SMALL["iters"]), "--lr", CHROME_SMALL["lr"], "--perturb",
            CHROME_SMALL["perturb"], "--seed", CHROME_SMALL["seed"], "--log-every",
            str(CHROME_SMALL["iters"] - 1), "--quiet"]
    summary, launches, wall = _counted(lambda: cli.main(argv))
    s0 = configs.perturb(small, sspec, scale=0.25, seed=0)
    final = summary["scene"]
    loss = summary["history"][-1]["loss"]  # the last step's, as the JAX test's losses[-1]
    err0, err1 = float(param_error(s0, small, sspec)), float(param_error(final, small, sspec))
    expect = {"fused_vec_step": CHROME_SMALL["iters"], "fused_vec_render": 1}
    row = dict(launches=launches, expected=expect, final_loss=loss, param_err_start=err0,
               param_err=err1,
               mirror_moved=float((final.spheres.material.mirror
                                   - s0.spheres.material.mirror).abs().max()),
               env_moved=float((final.env - s0.env).abs().max()), wall_seconds=wall)
    rows["invert_config10_48"] = row
    counts["invert_config10_48"] = launches
    oks.append(_only(launches, expect) and loss < 5e-4 and err1 < 0.8 * err0
               and row["mirror_moved"] > 1e-3 and row["env_moved"] > 1e-3)

    # ---- 20 steps of optimize(render_fn=render) on rows 4 + 5, on config 10 at its
    # recipe's learning rate and on config 5 with one bounce at the CLI's (as
    # phase render_grad_main's config-5 case)
    c5, c5spec, c5cfg = configs.CONFIGS[5](size=1024, device="cuda")
    c5cfg = dataclasses.replace(c5cfg, reflections=1)
    for run, truth, tspec, tcfg, scale, seed, lr in (
            ("render_fn_config10_512", scene, spec, cfg, 0.2, 10, 2e-2),
            ("render_fn_config5_reflections_1024", c5, c5spec, c5cfg, 0.05, 4, 1e-2)):
        la, launches, wall = _counted(
            lambda a=(truth, tspec, tcfg, scale, seed, lr): _render_fn_losses(*a))
        expect = {"fused_vec_render": CHROME_GRAD_ITERS + 1,
                  "fused_vec_render_bwd": CHROME_GRAD_ITERS}
        rows[run] = dict(launches=launches, expected=expect, first_loss=la[0],
                         final_loss=la[-1], wall_seconds=wall)
        counts[run] = launches
        oks.append(_only(launches, expect) and la[-1] < la[0]
                   and all(math.isfinite(x) for x in la))

    # ---- config 5 with one bounce at 1024^2
    png = out_dir / "final_config5_reflections.png"
    argv = ["invert", "--config", "5", "--reflections", "1", "--iters", str(CHROME_C5_ITERS),
            "--log-every", "1", "--quiet", "-o", str(png)]
    summary, launches, wall = _counted(lambda: cli.main(argv))
    hist = summary["history"]
    expect = {"fused_vec_step": CHROME_C5_ITERS, "fused_vec_render": 2}
    rows["invert_config5_reflections_1024"] = dict(
        launches=launches, expected=expect, first_loss=hist[0]["loss"],
        final_loss=hist[-1]["loss"], param_err=summary["param_err"],
        loop_ms_per_step=summary["seconds"] * 1e3 / CHROME_C5_ITERS, wall_seconds=wall)
    counts["invert_config5_reflections_1024"] = launches
    oks.append(_only(launches, expect) and hist[-1]["loss"] < hist[0]["loss"] and png.exists())
    rows["phase_seconds"] = time.perf_counter() - t_phase
    if not all(oks):
        raise AssertionError(f"a config-10 or config-5 bounce run did not run through the "
                             f"expected kernels or did not recover its leaves: {rows}")
    emit("chrome_main", ok=True, rows=rows)
    return counts


# The 64 textured globes (phases globes and globes_main): config 5's 64
# spheres + ground, each sphere with a (16, 16, 3) texel grid drawn
# uniform(0.1, 0.9) from default_rng(7), as the JAX package's
# scripts/vec_textured_tpu_check.py builds them (tex mode, :151-153 and
# :183-194; with a bounce its texrefl mode, :221-224: mirror coefficients
# uniform(0.2, 0.8) drawn next, reflections 1); trained on spheres.texture.
GLOBE_SIZE = 512
GLOBE_K = 16


def globes_case(size=GLOBE_SIZE, reflections=0, device="cuda"):
    """(scene, spec, cfg) of the textured globes at ``size``^2, with
    ``reflections`` bounce levels."""
    import dataclasses

    import numpy as np
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import ParamSpec

    scene, _, cfg = configs.config5_many_spheres(size, device=device)
    sp = scene.spheres
    rng = np.random.default_rng(7)
    tex = rng.uniform(0.1, 0.9, (sp.count, GLOBE_K, GLOBE_K, 3))
    sp = dataclasses.replace(sp, texture=torch.tensor(tex, dtype=torch.float32, device=device))
    if reflections:
        mir = torch.tensor(rng.uniform(0.2, 0.8, (sp.count,)), dtype=torch.float32, device=device)
        sp = dataclasses.replace(sp, material=dataclasses.replace(sp.material, mirror=mir))
    scene = dataclasses.replace(scene, spheres=sp)
    spec = ParamSpec.none(scene).train("spheres.texture", lower=0.0, upper=1.0)
    return scene, spec, dataclasses.replace(cfg, reflections=reflections)


GLOBE_CASES = (("globes_512", "globes", 0), ("globes_r1_512", "globes", 1),
               ("config7_r1_512", 7, 1), ("config8_r1_512", 8, 1))


def _globe_case(kind, refl, size=GLOBE_SIZE):
    """(scene, spec, cfg, start) of a case of phase globes: the globes
    (`globes_case`) or config 7 / 8 with ``refl`` bounce levels, from
    perturb(scale=0.4, seed=0) of their texels."""
    import dataclasses

    from reversible_raytracer_tpu_torch.models import configs

    if kind == "globes":
        scene, spec, cfg = globes_case(size, refl)
    else:
        scene, spec, cfg = configs.CONFIGS[kind](size=size, device="cuda")
        cfg = dataclasses.replace(cfg, reflections=refl)
    return scene, spec, cfg, configs.perturb(scene, spec, scale=0.4, seed=0)


def phase_globes():
    """Rows 4-6's textured instances on the 64 textured globes at 512^2
    without and with a bounce, and on configs 7 and 8 with one bounce at
    512^2 (see the module's docstring, phase 30). Returns each row's numbers
    per case."""
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    saved = {k.name: k.launches for k in _all_kernels()}
    rows, oks, numbers = {}, [], {}
    for label, kind, refl in GLOBE_CASES:
        scene, spec, cfg, start = _globe_case(kind, refl)
        case, ok, got = _vec_rows(scene, start, cfg)
        Sg = fused_vec.flatten_globals(start).numel()
        bounds, uncull, case["work"] = chrome_bounds(start, cfg, Sg,
                                                     fused_vec.n_vis_planes(start, cfg))
        nums = _vec_times(case, start, cfg, got.target, got.g, got.vis, bounds, label, uncull)
        for name, n in nums.items():
            numbers.setdefault(name, {})[n.pop("case")] = n
        tl = fused_vec.tex_levels(start, cfg)[1:]
        dims = (start.spheres.count, start.rects.count, start.lights.count, *tl)
        smem = dict(python=fused_vec.texel_step_smem_bytes(start),
                    step=fused.host_query(fused_vec.VEC_STEP, "rrt_vec_step_tex_smem", *dims),
                    render_bwd=fused.host_query(fused_vec.VEC_RENDER_BWD,
                                                "rrt_vec_render_bwd_tex_smem", *dims))
        case.update(Sg=Sg, texels=fused_vec.texel_row(start), smem_bytes=smem)
        rows[label] = case
        oks.append(ok and smem["python"] == smem["step"] == smem["render_bwd"])
    for k in _all_kernels():
        k.launches = saved[k.name]
    if not all(oks):
        raise AssertionError(f"a textured instance of rows 4-6 failed a check: {rows}")
    emit("globes", ok=True, rows=rows)
    return numbers


GLOBE_RUNS = ((8, 0.3), (7, 0.25))  # config, the texels' error bound of its JAX test
GLOBE_ITERS = 20


def phase_globes_main():
    """The CLI on configs 8 and 7 with one bounce, `optimize_scan` and
    `optimize(render_fn=render)` on the textured globes (see the module's
    docstring, phase 31). Returns each run's launch counts."""
    import time

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize, optimize_scan
    from reversible_raytracer_tpu_torch.ops.render import render

    out_dir = REPO / "smoke_out"
    rows, counts, oks = {}, {}, []
    t_phase = time.perf_counter()

    def texel_rms(scene, truth, spec, mask):
        for a, b, t in zip(tree_leaves(scene), tree_leaves(truth), tree_leaves(spec.trainable)):
            if t:
                return float(((a - b)[mask] ** 2).mean().sqrt())

    # ---- invert --config 8|7 --reflections 1, the JAX recipe, at 512^2 and 64^2
    for num, frac in GLOBE_RUNS:
        for size in TEX_RUN_SIZES:
            label = f"invert_config{num}_r1_{size}"
            png = out_dir / f"final_{label}.png"
            argv = ["invert", "--config", str(num), "--reflections", "1", "--size", str(size),
                    "--lr", "3e-2", "--perturb", "0.4", "--iters", str(TEX_ITERS), "--log-every",
                    str(TEX_ITERS - 1), "--quiet", "-o", str(png)]
            summary, launches, wall = _counted(lambda: cli.main(argv))
            scene, spec, cfg = _globe_case(num, 1, size)[:3]
            start = configs.perturb(scene, spec, scale=0.4, seed=0)
            mask = observable_texels(scene, spec, cfg)
            err0 = texel_rms(start, scene, spec, mask)
            err1 = texel_rms(summary["scene"], scene, spec, mask)
            hist = summary["history"]
            expect = {"fused_vec_step": TEX_ITERS, "fused_vec_render": 2}
            row = dict(launches=launches, expected=expect, first_loss=hist[0]["loss"],
                       final_loss=hist[-1]["loss"], observable_share=float(mask.float().mean()),
                       start_texel_rms=err0, texel_rms=err1, texel_rms_ratio=err1 / err0,
                       bound_ratio=frac, loop_seconds=summary["seconds"],
                       loop_ms_per_step=summary["seconds"] * 1e3 / TEX_ITERS, wall_seconds=wall)
            rows[label] = row
            counts[label] = launches
            ok = (_only(launches, expect) and row["final_loss"] < row["first_loss"]
                  and png.exists())
            if size == 64:  # the JAX tests' criteria (at 64^2)
                ok = ok and row["final_loss"] < 1e-5 and err1 < frac * err0
            oks.append(ok)

    # ---- the globes' texels: optimize_scan (row 6, captured) and optimize(render_fn=render)
    # (rows 4 + 5), without and with the bounce
    for refl in (0, 1):
        scene, spec, cfg, start = _globe_case("globes", refl)
        target = render(scene, cfg)
        ocfg = OptConfig(iters=GLOBE_ITERS, lr=3e-2)
        for run, fn, expect in (
                ("scan", lambda: optimize_scan(start, target, spec, cfg, ocfg)[1],
                 {"fused_vec_step": GLOBE_ITERS}),
                ("render_fn", lambda: optimize(start, target, spec, cfg, ocfg, log_every=0,
                                               render_fn=lambda s: render(s, cfg))[2],
                 {"fused_vec_render": GLOBE_ITERS, "fused_vec_render_bwd": GLOBE_ITERS})):
            losses, launches, wall = _counted(lambda: fn().cpu().tolist())
            label = f"{run}_globes_r{refl}_{GLOBE_SIZE}"
            rows[label] = dict(launches=launches, expected=expect, first_loss=losses[0],
                               final_loss=losses[-1], wall_seconds=wall)
            counts[label] = launches
            oks.append(_only(launches, expect) and losses[-1] < losses[0]
                       and all(math.isfinite(x) for x in losses))
    rows["phase_seconds"] = time.perf_counter() - t_phase
    if not all(oks):
        raise AssertionError(f"a textured-globe or config 7/8 bounce run did not run through the "
                             f"expected kernels or did not recover its texels: {rows}")
    emit("globes_main", ok=True, rows=rows)
    return counts


# Rows 7-9's texel instances (phases soft_texture and soft_texture_main): the
# JAX package's scripts/vec_textured_tpu_check.py softtex and softenv modes
# at 512^2, tau 0.05 (the globes, `globes_case`; the sky field: config 5's 64
# spheres + ground under a 16 x 16 sky uniform(0.1, 0.9) from default_rng(7),
# seen from (0, 1.5, 9.5) toward (0, 2.5, 0) at 60 degrees, so that misses
# exist), and configs 7, 8 and 9 (without its bounce) at 512^2, tau 0.08;
# each from perturb(scale=0.4, seed=0) of its trained texels.
SOFT_TEX_CASES = (("softtex_512", "globes", 0.05), ("softenv_512", "sky", 0.05),
                  ("config7_512", 7, 0.08), ("config8_512", 8, 0.08),
                  ("config9_r0_512", 9, 0.08))
SOFT_TEX_SIZE = 512


def sky_field_case(size=SOFT_TEX_SIZE, device="cuda"):
    """(scene, spec, cfg) of the sky field at ``size``^2: config 5's 64
    spheres + ground under a (16, 16, 3) sky, trained on the sky."""
    import dataclasses

    import numpy as np
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import Camera, ParamSpec

    scene, _, cfg = configs.config5_many_spheres(size, device=device)
    env = np.random.default_rng(7).uniform(0.1, 0.9, (GLOBE_K, GLOBE_K, 3))
    scene = dataclasses.replace(
        scene, env=torch.tensor(env, dtype=torch.float32, device=device),
        camera=Camera.make((0.0, 1.5, 9.5), (0.0, 2.5, 0.0), fov_deg=60.0, device=device))
    return scene, ParamSpec.none(scene).train("env", lower=0.0, upper=1.0), cfg


def _soft_tex_case(kind, tau, size=SOFT_TEX_SIZE):
    """(scene, spec, cfg, start) of a case of phase soft_texture at ``size``^2
    and soft_tau ``tau`` (no bounce), from perturb(scale=0.4, seed=0)."""
    import dataclasses

    from reversible_raytracer_tpu_torch.models import configs

    if kind == "globes":
        scene, spec, cfg = globes_case(size)
    elif kind == "sky":
        scene, spec, cfg = sky_field_case(size)
    else:
        scene, spec, cfg = configs.CONFIGS[kind](size=size, device="cuda")
    cfg = dataclasses.replace(cfg, soft_tau=tau, reflections=0)
    return scene, spec, cfg, configs.perturb(scene, spec, scale=0.4, seed=0)


def _soft_texel_leaf(grads, scene):
    """The gradient of a scene's texel grids (the objects' and the env's), flat."""
    import torch

    leaves = [grads.spheres.texture, grads.rects.texture] + ([grads.env] if scene.env_mapped
                                                             else [])
    return torch.cat([x.reshape(-1) for x in leaves])


def prefix_overflow(scene, cfg, pcaps):
    """The share of the warps (32 pixels of a row) whose shadow walks, over
    both soft layers and every light (`cull.warp_candidates` at tau), hold
    more candidates than each ``pcaps`` value: where the soft step's kept
    prefixes run out and its backward walk rebuilds them."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops import pipeline_vec as pv
    from reversible_raytracer_tpu_torch.ops.kernels import cull

    with torch.no_grad():
        o, d = pl.primary_rays(scene, cfg)
        total = 0
        for _, k in pv.two_layers(scene, o, d, cfg.soft_tau):
            tt, lv, at, _ = pv.soft_layer(scene, o, d, k, cfg.soft_tau, cfg.shape)
            so = pl.shadow_origin(o, d, tt, (at["nx"], at["ny"], at["nz"]))
            for li in range(scene.lights.count):
                total = total + cull.warp_candidates(scene.spheres, so, lv,
                                                     scene.lights.position[li],
                                                     cfg.soft_tau).sum(-1)
    return {str(p): float((total > p).float().mean()) for p in pcaps}


def soft_texture_bounds(start, cfg, nbytes):
    """Rows 7, 8 and 9's bounds on a scene with texel grids: (ms, by) each,
    `soft_work_counts` with `texel_ops` of both layers' textured winners and
    the environment's sample at every pixel; ``nbytes``: each row's bytes.
    At spp 4 each subsample's counts summed (`spp_work`)."""
    c = spp_work(soft_work_counts, start, cfg)
    sp, rc = start.spheres, start.rects
    t = dict(tex_sph=c["live_sph"] if sp.textured else 0,
             tex_rect=c["live_rect"] if rc.textured else 0, tex_sph1=0, tex_rect1=0,
             env0=c["pixels"] if start.env_mapped else 0, env1=0)
    ops = dict(fused_vec_soft_render=soft_render_ops(c, cull=True) + texel_ops(t, False),
               fused_vec_soft_step=soft_step_ops(c) + texel_ops(t, True),
               fused_vec_soft_render_bwd=soft_bwd_ops(c) + texel_ops(t, True))
    return {name: bound(ops[name], nbytes[name]) for name in ops}, dict(c, **t)


def phase_soft_texture():
    """Rows 7, 8 and 9's texel instances (the ``_tex`` entries) on the
    SOFT_TEX_CASES (see the module's docstring, phase 32). Returns each
    row's numbers per case."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft as fvs
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render, resolve_impl

    saved = {k.name: k.launches for k in _all_kernels()}
    stream = torch.cuda.current_stream().cuda_stream
    optin = fused.host_query(fused_vec.VEC_RENDER, "rrt_smem_optin")
    rows, oks, numbers = {}, [], {}
    flat = lambda loss, g: torch.cat([loss.reshape(1), fused.flatten_scene(g)])  # noqa: E731
    for label, kind, tau in SOFT_TEX_CASES:
        scene, _, cfg, start = _soft_tex_case(kind, tau)
        H, W = cfg.height, cfg.width
        case = dict(impl=resolve_impl(start, cfg))
        ok = [case["impl"] == "cuda_vec_soft"]
        # ---- row 7 against its plain version (the oracle rule), three calls
        before = fvs.SOFT_RENDER.launches
        imgs = [fvs.render_vec_soft(start, cfg) for _ in range(3)]
        per_call = (fvs.SOFT_RENDER.launches - before) / 3
        img_p = fvs.render_vec_soft_plain(start, cfg)
        torch.cuda.synchronize()
        err = (imgs[0] - img_p).abs()
        r = dict(wrapper_launches_per_call=per_call, frac_bad=float((err > 2e-3).float().mean()),
                 mean_err=float(err.mean()), max_abs_err=float(err.max()),
                 bit_identical=bool(torch.equal(imgs[0], img_p)),
                 deterministic=all(torch.equal(imgs[0], i) for i in imgs[1:]),
                 finite=bool(torch.isfinite(imgs[0]).all()))
        case["fused_vec_soft_render"] = r
        ok.append(r["frac_bad"] < 1e-3 and r["mean_err"] < 1e-4 and r["deterministic"]
                  and r["finite"] and per_call == 1)
        # ---- row 9: zero against row 7's own image, then autograd and the twin
        target = fvs.render_vec_soft_plain(scene, cfg)
        l_0, g_0 = fvs.loss_grad_vec_soft(scene, cfg, fvs.render_vec_soft(scene, cfg))
        before = fvs.SOFT_STEP.launches
        runs = [fvs.loss_grad_vec_soft(start, cfg, target) for _ in range(3)]
        per_call = (fvs.SOFT_STEP.launches - before) / 3
        l_k, g_k = runs[0]
        r = dict(wrapper_launches_per_call=per_call, loss=float(l_k),
                 zero_residual_exact=bool(float(l_0) == 0.0
                                          and not fused.flatten_scene(g_0).any()),
                 deterministic=all(torch.equal(flat(*runs[0]), flat(*x)) for x in runs[1:]),
                 texel_grad_nonzero=float((_soft_texel_leaf(g_k, start) != 0).float().mean()))
        good = r["zero_residual_exact"] and r["deterministic"] and per_call == 1
        for name, ref in (("autograd", fvs.loss_grad_vec_soft_plain),
                          ("adjoint_eager", fvs.loss_grad_vec_soft_adjoint_eager)):
            l_r, g_r = ref(start, cfg, target)
            rel = abs(float(l_k) - float(l_r)) / max(abs(float(l_r)), 1e-12)
            good = _check_grads(r, name, g_r, g_k) and good and rel <= 1e-4
            r[name]["loss_rel"] = rel
        r["max_abs_err"] = r["autograd"]["max_abs_err"]
        case["fused_vec_soft_step"] = r
        ok.append(good and r["texel_grad_nonzero"] > 0)
        # ---- row 8 by autograd of `render`: against the plain render's autograd
        # and the twin; its mse gradient row 9's bit for bit
        g = _seeded_cotangent(cfg)
        before = fvs.SOFT_RENDER_BWD.launches
        bwds = [_bwd(start, cfg, g) for _ in range(3)]
        per_call = (fvs.SOFT_RENDER_BWD.launches - before) / 3
        leaves = [x.clone().requires_grad_(True) for x in tree_leaves(start)]
        ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
        by_render = torch.cat([(torch.zeros_like(x) if x.grad is None else x.grad).reshape(-1)
                               for x in leaves])
        by_step = fused.flatten_scene(loss_and_grad_fn(start, cfg)(start, target)[1])
        r = dict(wrapper_launches_per_call=per_call,
                 deterministic=all(torch.equal(fused.flatten_scene(bwds[0]),
                                               fused.flatten_scene(b)) for b in bwds[1:]),
                 texel_grad_nonzero=float((_soft_texel_leaf(bwds[0], start) != 0)
                                          .float().mean()),
                 mse_bit_equal_to_row9=bool(torch.equal(by_render, by_step)),
                 mse_max_abs_diff_to_row9=float((by_render - by_step).abs().max()))
        good = _check_grads(r, "plain", fvs.render_vec_soft_bwd_plain(start, cfg, g), bwds[0])
        good = _check_grads(r, "twin", fvs.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                            bwds[0]) and good
        r["max_abs_err"] = r["plain"]["max_abs_err"]
        case["fused_vec_soft_render_bwd"] = r
        ok.append(good and r["deterministic"] and r["mse_bit_equal_to_row9"] and per_call == 1
                  and r["texel_grad_nonzero"] > 0)
        # ---- the textured step's block: shared memory and prefix slots, Python's
        # count against the C entries', beside the same scene without its grids
        sides = fused_vec.tex_levels(start, cfg)[1:]  # ke, ks, kr
        dims = (start.spheres.count, start.rects.count, start.lights.count)
        plan = fvs.soft_step_plan(start, optin)
        smem = dict(python=plan["smem"],
                    step=fused.host_query(fvs.SOFT_STEP, "rrt_soft_step_tex_smem", *dims, *sides),
                    render_bwd=fused.host_query(fvs.SOFT_RENDER_BWD,
                                                "rrt_soft_render_bwd_tex_smem", *dims, *sides))
        bare = dataclasses.replace(
            start, env=start.env[:0, :0],
            spheres=dataclasses.replace(start.spheres, texture=start.spheres.texture[:, :0, :0]),
            rects=dataclasses.replace(start.rects, texture=start.rects.texture[:, :0, :0]))
        pcap = dict(python=plan["pcap"],
                    c=fused.host_query(fvs.SOFT_STEP, "rrt_soft_step_pcap", *dims, *sides),
                    without_grids_python=fvs.soft_step_plan(bare, optin)["pcap"],
                    without_grids_c=fused.host_query(fvs.SOFT_STEP, "rrt_soft_step_pcap", *dims,
                                                     0, 0, 0))
        case.update(smem_bytes=smem, pcap=pcap, texels=fused_vec.texel_row(start),
                    Sg=plan["Sg"],
                    prefix_overflow=prefix_overflow(start, cfg, (pcap["c"], fvs.PCAP)))
        ok.append(smem["python"] == smem["step"] == smem["render_bwd"]
                  and pcap["python"] == pcap["c"]
                  and pcap["without_grids_python"] == pcap["without_grids_c"])
        # ---- times on the ``_tex`` entries, the plain versions', the bounds
        glob, sph, rct, stex, rtex = fvs._cuda_inputs(start, cfg)
        geom = fused_vec._geometry(start, cfg)
        ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), stex.data_ptr(),
                rtex.data_ptr(), *geom)
        img = torch.empty((H, W, 3), device="cuda")
        out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel()
                           + fused_vec.texel_row(start),), device="cuda")
        scratch = torch.empty((fused.host_query(fvs.SOFT_STEP, "rrt_soft_step_tex_scratch_floats",
                                                *dims[:2], dims[2], H, W, *sides),),
                              device="cuda")
        calls = {
            "fused_vec_soft_render": lambda: fvs.SOFT_RENDER.call(
                "rrt_soft_render_tex", *ptrs, 0.0, 0.0, tau, *sides, img.data_ptr(), stream),
            "fused_vec_soft_step": lambda: fvs.SOFT_STEP.call(
                "rrt_soft_step_tex", *ptrs, tau, *sides, target.data_ptr(), 1.0 / (H * W * 3),
                scratch.data_ptr(), out.data_ptr(), stream),
            "fused_vec_soft_render_bwd": lambda: fvs.SOFT_RENDER_BWD.call(
                "rrt_soft_render_bwd_tex", *ptrs, 0.0, 0.0, tau, *sides, g.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), stream)}
        plain = {"fused_vec_soft_render": lambda: fvs.render_vec_soft_plain(start, cfg),
                 "fused_vec_soft_step": lambda: fvs.loss_grad_vec_soft_plain(start, cfg, target),
                 "fused_vec_soft_render_bwd": lambda: fvs.render_vec_soft_bwd_plain(start, cfg,
                                                                                    g)}
        Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
        n_rows, n_tex = 4 * (Sg + ns_pad * 17 + nr_pad * 22), 4 * fused_vec.texel_row(start)
        nbytes = dict(fused_vec_soft_render=n_rows + n_tex + 4 * H * W * 3,
                      fused_vec_soft_step=2 * (n_rows + n_tex) + 4 * (H * W * 3 + 1),
                      fused_vec_soft_render_bwd=2 * (n_rows + n_tex) + 4 * (H * W * 3 + 1))
        bounds, case["work"] = soft_texture_bounds(start, cfg, nbytes)
        for name, fn in calls.items():
            dev = device_ms(fn)
            case[name].update(ms=time_ms(fn), device_ms=dev["ms"],
                              launches_per_call=dev["launches"], device=dev,
                              plain_ms=time_ms(plain[name], **VEC_PLAIN_REPS),
                              bound_ms=bounds[name][0], bound_by=bounds[name][1])
            numbers.setdefault(name, {})[label] = {
                k: case[name][k] for k in ("ms", "device_ms", "launches_per_call",
                                           "wrapper_launches_per_call", "max_abs_err",
                                           "plain_ms", "bound_ms", "bound_by")}
        rows[label] = case
        oks.append(all(ok))
    for k in _all_kernels():
        k.launches = saved[k.name]
    if not all(oks):
        raise AssertionError(f"a texel instance of rows 7-9 failed a check: {rows}")
    emit("soft_texture", ok=True, rows=rows)
    return numbers


SOFT_TEX_TAUS = (0.08, 0.03, 0.01, 0.0)
SOFT_TEX_ITERS = 50
SOFT_TEX_RUN_SIZES = (512, 64)
SOFT_TEX_OPT_ITERS = 20


def phase_soft_texture_main():
    """`invert --anneal` on configs 7, 8 and 9 (without its bounce), and
    `optimize_annealed` and optimize(render_fn=render) on the globes and the
    sky field (see the module's docstring, phase 33). Returns each run's
    launch counts."""
    import dataclasses
    import time

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize, optimize_annealed
    from reversible_raytracer_tpu_torch.ops.render import render

    rows, counts, oks = {}, {}, []
    t_phase = time.perf_counter()
    n = len(SOFT_TEX_TAUS)

    def texel_rms(scene, truth, spec, mask):
        for a, b, t in zip(tree_leaves(scene), tree_leaves(truth), tree_leaves(spec.trainable)):
            if t:
                return float(((a - b)[mask] ** 2).mean().sqrt())

    def stages(la, iters):
        return [la[i * iters:(i + 1) * iters] for i in range(n)]

    # ---- invert --config 7|8|9 --anneal (config 9 without its bounce)
    for num in (7, 8, 9):
        for size in SOFT_TEX_RUN_SIZES:
            label = f"invert_config{num}_anneal_{size}"
            argv = ["invert", "--config", str(num), "--size", str(size), "--anneal",
                    ",".join(str(t) for t in SOFT_TEX_TAUS), "--lr", "3e-2", "--perturb", "0.4",
                    "--iters", str(SOFT_TEX_ITERS), "--log-every", "0", "--quiet", "-o",
                    str(REPO / "smoke_out" / f"final_{label}.png")]
            if num == 9:
                argv += ["--reflections", "0"]
            summary, launches, wall = _counted(lambda: cli.main(argv))
            scene, spec, cfg = configs.CONFIGS[num](size=size, device="cuda")
            cfg = dataclasses.replace(cfg, reflections=0)
            start = configs.perturb(scene, spec, scale=0.4, seed=0)
            mask = observable_texels(scene, spec, cfg)
            err0 = texel_rms(start, scene, spec, mask)
            err1 = texel_rms(summary["scene"], scene, spec, mask)
            st = stages(summary["losses"], SOFT_TEX_ITERS)
            expect = {"fused_vec_soft_render": n - 1,
                      "fused_vec_soft_step": (n - 1) * SOFT_TEX_ITERS,
                      "fused_step": SOFT_TEX_ITERS, "fused_render": 2}
            rows[label] = dict(launches=launches, expected=expect,
                               stage_first_last=[[x[0], x[-1]] for x in st],
                               start_texel_rms=err0, texel_rms=err1, texel_rms_ratio=err1 / err0,
                               loop_seconds=summary["seconds"], wall_seconds=wall)
            counts[label] = launches
            oks.append(_only(launches, expect) and all(x[-1] < x[0] for x in st)
                       and all(math.isfinite(x) for x in summary["losses"]) and err1 < err0)

    # ---- optimize_annealed on the globes' texels and the sky field's env
    for kind in ("globes", "sky"):
        scene, spec, cfg = globes_case() if kind == "globes" else sky_field_case()
        start = configs.perturb(scene, spec, scale=0.4, seed=0)
        target = render(scene, cfg).detach()
        ocfg = OptConfig(iters=SOFT_TEX_OPT_ITERS, lr=3e-2)
        (final, losses), launches, wall = _counted(lambda: optimize_annealed(
            start, target, spec, cfg, ocfg, taus=SOFT_TEX_TAUS, target_scene=scene))
        la = losses.cpu().tolist()
        st = stages(la, SOFT_TEX_OPT_ITERS)
        expect = {"fused_vec_soft_render": n - 1,
                  "fused_vec_soft_step": (n - 1) * SOFT_TEX_OPT_ITERS,
                  "fused_vec_step": SOFT_TEX_OPT_ITERS}
        label = f"anneal_{kind}_{SOFT_TEX_SIZE}"
        rows[label] = dict(launches=launches, expected=expect,
                           stage_first_last=[[x[0], x[-1]] for x in st], wall_seconds=wall)
        counts[label] = launches
        oks.append(_only(launches, expect) and all(x[-1] < x[0] for x in st)
                   and all(math.isfinite(x) for x in la))

    # ---- optimize(render_fn=render) at tau 0.05 on the globes, its target
    # rendered in the run: rows 7 and 8
    scene, spec, cfg, start = _soft_tex_case("globes", 0.05)

    def by_render():
        target = render(scene, cfg).detach()
        return optimize(start, target, spec, cfg, OptConfig(iters=SOFT_TEX_OPT_ITERS, lr=3e-2),
                        log_every=0, render_fn=lambda s: render(s, cfg))[2].cpu().tolist()

    la, launches, wall = _counted(by_render)
    expect = {"fused_vec_soft_render": SOFT_TEX_OPT_ITERS + 1,
              "fused_vec_soft_render_bwd": SOFT_TEX_OPT_ITERS}
    label = f"render_fn_globes_{SOFT_TEX_SIZE}"
    rows[label] = dict(launches=launches, expected=expect, first_loss=la[0], final_loss=la[-1],
                       wall_seconds=wall)
    counts[label] = launches
    oks.append(_only(launches, expect) and la[-1] < la[0] and all(math.isfinite(x) for x in la))
    rows["phase_seconds"] = time.perf_counter() - t_phase
    if not all(oks):
        raise AssertionError(f"a soft texel run did not run through the expected kernels or did "
                             f"not descend: {rows}")
    emit("soft_texture_main", ok=True, rows=rows)
    return counts


RESTART_SIZE = 512
RESTART_RANKS = (1, 2, 3, 4)
RESTART_JITTER, RESTART_SEED = 0.3, 7
RESTART_TIE = 1e-4  # suspicions closer than this, relative: the suspect may differ by device
RESTART_REL = 1e-5  # a resid proposal's leaves, card against CPU, relative to each leaf's largest
RESTART_SMALL = dict(size=64, iters=30, restarts=3, seed=1002)  # the chained run's mechanics
RESTART_TAUS = (0.08, 0.03, 0.0)


def _near_tie(suspicion, rank):
    """Whether the rank-th suspect's suspicion lies within RESTART_TIE
    (relative) of a neighbour's in the order of `optim.reseed_pick`, where
    the card's and the CPU's renders may order two spheres differently."""
    import numpy as np

    s = suspicion[np.argsort(-suspicion, kind="stable")]
    k = rank % len(s)
    pairs = [(s[j], s[j + 1]) for j in (k - 1, k) if 0 <= j < len(s) - 1]
    return any(np.isfinite(a) and np.isfinite(b)
               and abs(a - b) <= RESTART_TIE * max(abs(a), abs(b)) for a, b in pairs)


def _resid_card_vs_cpu(start, spec, target, cfg, ranks):
    """The `resid` proposals of ``ranks`` on the card against the port's CPU
    result from the same start and target: the same suspect (where no
    near-tie guards it) and peak pixel, every leaf within RESTART_REL of its
    largest. Returns (ok, a row of the comparisons)."""
    import numpy as np

    from reversible_raytracer_tpu_torch import optim
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_map

    cpu_start = tree_map(lambda l: l.cpu(), start)
    cpu_target = target.cpu()
    card_attr = [x.cpu().numpy() for x in optim.restart_attribution(start, target, cfg)]
    cpu_attr = [x.numpy() for x in optim.restart_attribution(cpu_start, cpu_target, cfg)]
    ok, guarded, rows = True, 0, []
    for r in ranks:
        pick_k = optim.reseed_pick(*card_attr, r - 1)
        pick_c = optim.reseed_pick(*cpu_attr, r - 1)
        tie = _near_tie(cpu_attr[1], r - 1)
        guarded += tie
        card = optim.propose_restart(start, spec, r, RESTART_JITTER, RESTART_SEED, "resid",
                                     target=target, rcfg=cfg)
        cpu = optim.propose_restart(cpu_start, spec, r, RESTART_JITTER, RESTART_SEED, "resid",
                                    target=cpu_target, rcfg=cfg)
        rel = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(tree_leaves(card), tree_leaves(cpu)) if b.numel())
        same = pick_k == pick_c
        ok = ok and (pick_k[1] == pick_c[1]) and (tie or (same and rel <= RESTART_REL))
        rows.append(dict(r=r, card=[pick_k[0], list(pick_k[1])], cpu=[pick_c[0], list(pick_c[1])],
                         near_tie=bool(tie), max_rel=rel))
    sk, sc = card_attr[1], cpu_attr[1]
    fin = np.isfinite(sc)
    ok = ok and np.array_equal(np.isfinite(sk), fin)  # the same spheres nearest nowhere
    return ok, dict(proposals=rows, guard_fired=guarded, of=len(ranks), nowhere=int((~fin).sum()),
                    suspicion_max_rel=float(np.max(np.abs(sk[fin] - sc[fin]) / sc[fin], initial=0.0)))


def phase_restarts():
    """The restart proposals and the multistart's graphs and start (see the
    module's docstring, phase 34). Returns the chained run's launches."""
    import time

    import torch

    from reversible_raytracer_tpu_torch import optim
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_map
    from reversible_raytracer_tpu_torch.ops.render import mse_loss, render

    rows, oks = {}, []
    t_phase = time.perf_counter()

    # ---- config 2 at 512^2: every family's proposals, card against CPU
    scene, spec, cfg = configs.config2_four_spheres(size=RESTART_SIZE, device="cuda")
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.45, seed=2)
    cpu_start = tree_map(lambda l: l.cpu(), start)
    blind = {}
    for family in (f for f in optim.RESTART_PROPOSALS if f != "resid"):
        same = all(
            all(torch.equal(a.cpu(), b) for a, b in zip(
                tree_leaves(optim.propose_restart(start, spec, r, RESTART_JITTER, RESTART_SEED,
                                                  family)),
                tree_leaves(optim.propose_restart(cpu_start, spec, r, RESTART_JITTER,
                                                  RESTART_SEED, family))))
            for r in RESTART_RANKS)
        blind[family] = same
        oks.append(same)
    ok2, rows["resid_config2_512"] = _resid_card_vs_cpu(start, spec, target, cfg, RESTART_RANKS)
    rows["blind_config2_512_bit_identical"] = blind
    oks.append(ok2)

    # ---- config 5 at 512^2: resid through row 4
    scene5, spec5, cfg5 = configs.config5_many_spheres(size=RESTART_SIZE, device="cuda")
    target5 = render(scene5, cfg5).detach()
    start5 = configs.perturb(scene5, spec5, scale=0.03, seed=0)
    ok5, rows["resid_config5_512"] = _resid_card_vs_cpu(start5, spec5, target5, cfg5,
                                                        RESTART_RANKS)
    oks.append(ok5)

    # ---- a chained resid multistart at 64^2: restart 0 is the plain
    # anneal's bits, no capture beyond the anneal's, the start untouched
    small = RESTART_SMALL
    scene, spec, cfg = configs.config2_four_spheres(size=small["size"], device="cuda")
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.45, seed=2)
    before = [l.clone() for l in tree_leaves(start)]
    ocfg = optim.OptConfig(iters=small["iters"], lr=1e-2)
    kw = dict(taus=RESTART_TAUS, target_scene=scene)
    n0 = len(optim._SCAN_CACHE)
    final, _ = optim.optimize_annealed(start, target, spec, cfg, ocfg, **kw)
    with torch.no_grad():
        plain = float(mse_loss(render(final, cfg), target))
    n1 = len(optim._SCAN_CACHE)
    (best, best_loss, finals), launches, wall = _counted(lambda: optim.optimize_multistart(
        start, target, spec, cfg, ocfg, restarts=small["restarts"], jitter=RESTART_JITTER,
        seed=small["seed"], proposal="resid", chain=True, **kw))
    n2 = len(optim._SCAN_CACHE)
    untouched = all(torch.equal(a, b) for a, b in zip(before, tree_leaves(start)))
    k, iters = small["restarts"], small["iters"]
    soft = sum(t > 0 for t in RESTART_TAUS)
    expect = {"fused_vec_soft_render": k * soft, "fused_vec_soft_step": k * soft * iters,
              "fused_step": k * iters, "fused_render": k + (k - 1)}
    label = f"multistart_config2_{small['size']}"
    rows[label] = dict(finals=finals, best=best_loss, plain_anneal=plain,
                       restart0_bits=finals[0] == plain, scan_cache=[n0, n1, n2],
                       start_untouched=untouched, launches=launches, expected=expect,
                       wall_seconds=wall)
    oks.append(finals[0] == plain and n2 == n1 and untouched and best_loss == min(finals)
               and _only(launches, expect) and all(math.isfinite(x) for x in finals))
    rows["phase_seconds"] = time.perf_counter() - t_phase
    if not all(oks):
        raise AssertionError(f"a restart check failed: {rows}")
    emit("restarts", ok=True, rows=rows)
    return {label: launches}


# (label, argv, launches): each soft stage's target and steps (rows 7, 9), the
# polish (row 1 or 6), and the forward (row 2 or 4) for the CLI's target, one
# ranking a restart and one attribution a resid restart after the first
RESTART_RUNS = (
    ("stall_config2_512", ["--config", "2", "--size", "512", "--iters", "150", "--perturb", "0.45",
                           "--seed", "2", "--anneal", "0.08,0.03,0", "--restarts", "12",
                           "--restart-jitter", "0.3", "--restart-proposal", "resid",
                           "--restart-chain"],
     {"fused_vec_soft_render": 12 * 2, "fused_vec_soft_step": 12 * 2 * 150,
      "fused_step": 12 * 150, "fused_render": 1 + 12 + 11}),
    ("chain_config5_512", ["--config", "5", "--size", "512", "--anneal", "0.08,0", "--iters", "20",
                           "--perturb", "0.03", "--lr", "2e-3", "--restarts", "3",
                           "--restart-proposal", "resid", "--restart-chain"],
     {"fused_vec_soft_render": 3, "fused_vec_soft_step": 3 * 20, "fused_vec_step": 3 * 20,
      "fused_vec_render": 1 + 3 + 2}),
)
STALL_LOSS, STALL_RMS = 1e-6, 1e-3  # the recipe's recovery (JAX's run: 7.0e-11, RMS 0.00000)


def phase_restarts_main():
    """`invert --restarts` on the card at full width: config 2's documented
    stall recipe and a chained config-5 run (see the module's docstring,
    phase 35). Returns each run's launch counts."""
    from reversible_raytracer_tpu_torch import cli

    rows, counts, oks = {}, {}, []
    for label, args, expect in RESTART_RUNS:
        argv = ["invert", *args, "--quiet"]
        summary, launches, wall = _counted(lambda: cli.main(argv))
        finals, best = summary["finals"], summary["best_loss"]
        row = dict(launches=launches, expected=expect, finals=finals, best=best,
                   restart0_final=finals[0], winner=finals.index(best),
                   param_err=summary["param_err"], start_param_err=summary["start_param_err"],
                   loop_seconds=summary["seconds"], wall_seconds=wall)
        ok = (_only(launches, expect) and all(math.isfinite(x) for x in finals)
              and best == min(finals) and len(finals) == int(args[args.index("--restarts") + 1]))
        if label.startswith("stall"):
            ok = ok and best < STALL_LOSS and summary["param_err"] < STALL_RMS
        rows[label] = row
        counts[label] = launches
        oks.append(ok)
    if not all(oks):
        raise AssertionError(f"a restart run missed its kernels or its recovery: {rows}")
    emit("restarts_main", ok=True, rows=rows)
    return counts


BAND_CASES = (  # (label, config, size, tau, the rows' kernels: step, forward, backward)
    ("config2_512", 2, 512, 0.0, ("fused_step", "fused_render", "fused_render_bwd")),
    ("config5_1024", 5, 1024, 0.0, ("fused_vec_step", "fused_vec_render",
                                    "fused_vec_render_bwd")),
    ("config5_512_t0.08", 5, 512, 0.08, ("fused_vec_soft_step", "fused_vec_soft_render",
                                         "fused_vec_soft_render_bwd")),
)
BAND_COUNTS = (2, 4)
BAND_TOL = 1e-4  # the bands' sums against the whole image, of each leaf's scale


def _band_calls(start, cfg, target, g):
    """(forward, step, backward) of ``start`` as the wrappers launch them on
    ``cfg`` (a band's or the whole image's), each a no-argument call; the
    backward is the family's launch of its render backward kernel on the
    forward's planes and the cotangent's rows."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn

    rows = slice(cfg.row0, cfg.row0 + cfg.height)
    t, gb = target[rows].contiguous(), g[rows].contiguous()
    step = loss_and_grad_fn(start, cfg)
    off = (0.0, 0.0)
    with torch.no_grad():
        if cfg.soft_tau > 0:
            ins = fused_vec_soft._cuda_inputs(start, cfg)
            fwd = lambda: fused_vec_soft.render_vec_soft(start, cfg)  # noqa: E731
            bwd = lambda: fused_vec_soft._render_bwd_launch(start, cfg, off, *ins, gb)  # noqa: E731
        elif start.spheres.count + start.rects.count > fused.MAX_OBJECTS:
            ins = fused_vec._cuda_inputs(start, cfg)
            vis = fused_vec.render_vec(start, cfg)[1]
            fwd = lambda: fused_vec.render_vec(start, cfg)  # noqa: E731
            bwd = lambda: fused_vec._render_bwd_launch(start, cfg, off, *ins, gb, vis)  # noqa: E731
        else:
            flat, vis = fused._cuda_flat(start, cfg), fused.render_fused(start, cfg)[1]
            fwd = lambda: fused.render_fused(start, cfg)  # noqa: E731
            bwd = lambda: fused.unflatten_scene(  # noqa: E731
                start, fused._render_bwd_launch(start, cfg, flat, gb, vis))
    return fwd, (lambda: step(start, t)), bwd


def _tree_sum(trees):
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten

    total = [l.clone() for l in tree_leaves(trees[0])]
    for tr in trees[1:]:
        total = [a + b for a, b in zip(total, tree_leaves(tr))]
    return tree_unflatten(trees[0], total)


def phase_bands():
    """Rows 1-9 in 2 and 4 row bands against the whole image and their plain
    versions (see the module's docstring, phase 36). Returns each row's
    numbers by kernel name."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
    from reversible_raytracer_tpu_torch.ops.pipeline import band_config
    from reversible_raytracer_tpu_torch.ops.render import render

    out, oks, rows = {}, [], {}
    for label, num, size, tau, (step_k, fwd_k, bwd_k) in BAND_CASES:
        scene, spec, cfg = configs.CONFIGS[num](size=size, device="cuda")
        cfg = dataclasses.replace(cfg, soft_tau=tau)
        soft = tau > 0
        start = configs.perturb(scene, spec, scale=0.05, seed=1)
        target = render(scene, cfg).detach()
        g = _seeded_cotangent(cfg)
        fwd, step, bwd = _band_calls(start, cfg, target, g)
        with torch.no_grad():
            whole_f, (whole_l, whole_g), whole_b = fwd(), step(), bwd()
        row = dict(case=label, whole_device_ms={k: device_ms(fn)["ms"] for k, fn in (
            (fwd_k, fwd), (step_k, step), (bwd_k, bwd))})
        worst = {fwd_k: 0.0, step_k: 0.0, bwd_k: 0.0}
        for n in BAND_COUNTS:
            b = cfg.height // n
            bcfgs = [band_config(cfg, i * b, b) for i in range(n)]
            calls = [_band_calls(start, c, target, g) for c in bcfgs]
            with torch.no_grad():
                fs = [c[0]() for c in calls]
                ss = [c[1]() for c in calls]
                bs = [c[2]() for c in calls]
            img = torch.cat([f if soft else f[0] for f in fs])
            bits = bool(torch.equal(img, whole_f if soft else whole_f[0]))
            if not soft:
                bits = bits and bool(torch.equal(torch.cat([f[1] for f in fs], dim=1),
                                                 whole_f[1]))
            loss_sum = sum(float(l) for l, _ in ss)
            loss_rel = abs(loss_sum - float(whole_l)) / float(whole_l)
            step_errs = _grad_errors(whole_g, _tree_sum([gr for _, gr in ss]))
            bwd_errs = _grad_errors(whole_b, _tree_sum(bs))
            w_step, w_bwd = max(max(step_errs.values()), loss_rel), max(bwd_errs.values())
            worst[step_k] = max(worst[step_k], w_step)
            worst[bwd_k] = max(worst[bwd_k], w_bwd)
            row[f"bands{n}"] = dict(
                forward_bits=bits, step_loss_rel=loss_rel, step_worst=w_step,
                step_worst_leaf=max(step_errs, key=step_errs.get), bwd_worst=w_bwd,
                bwd_worst_leaf=max(bwd_errs, key=bwd_errs.get),
                device_ms={k: sum(device_ms(c[i])["ms"] for c in calls)
                           for i, k in enumerate((fwd_k, step_k, bwd_k))})
            oks.append(bits and w_step <= BAND_TOL and w_bwd <= BAND_TOL)
        # the last band of 4 against its plain version at its row0
        last = bcfgs[-1]
        r0, h = last.row0, last.height
        tb, gb = target[r0:r0 + h], g[r0:r0 + h]
        fam = (fused_vec_soft if soft else fused_vec if num == 5 else fused)
        fwd_plain = {fused: fused.render_fused_plain, fused_vec: fused_vec.render_vec_plain,
                     fused_vec_soft: fused_vec_soft.render_vec_soft_plain}[fam]
        step_plain = {fused: fused.loss_grad_fused_plain, fused_vec: fused_vec.loss_grad_vec_plain,
                      fused_vec_soft: fused_vec_soft.loss_grad_vec_soft_plain}[fam]
        bwd_plain = {fused: fused.render_fused_bwd_plain, fused_vec: fused_vec.render_vec_bwd_plain,
                     fused_vec_soft: fused_vec_soft.render_vec_soft_bwd_plain}[fam]
        pf = fwd_plain(start, cfg, r0, h)
        kf = fs[-1]
        if soft:
            err = (kf - pf).abs()
            f_ok = bool(float((err > 2e-3).float().mean()) < 1e-3 and float(err.mean()) < 1e-4)
            f_err = float(err.max())
        else:
            f_ok = bool(torch.equal(kf[0], pf[0]))
            f_err = float((kf[0] - pf[0]).abs().max())
        lp, gp = step_plain(start, cfg, tb, row0=r0, out_height=h)
        lk, gk = ss[-1]
        s_rel = abs(float(lk) - float(lp)) / float(lp)
        s_errs = _grad_errors(gp, gk)
        b_errs = _grad_errors(bwd_plain(start, last, gb), bs[-1])
        row["last_band_vs_plain"] = dict(row0=r0, rows=h, forward_ok=f_ok, forward_max_abs=f_err,
                                         step_loss_rel=s_rel, step_worst=max(s_errs.values()),
                                         bwd_worst=max(b_errs.values()))
        oks.append(f_ok and s_rel <= 1e-4 and max(s_errs.values()) <= 1e-2
                   and max(b_errs.values()) <= 1e-2)
        worst[fwd_k] = 0.0 if all(row[f"bands{n}"]["forward_bits"] for n in BAND_COUNTS) \
            else float("inf")
        rows[label] = row
        for k in (fwd_k, step_k, bwd_k):
            out[k] = dict(case=label, worst=worst[k], whole_device_ms=row["whole_device_ms"][k],
                          **{f"bands{n}_device_ms": row[f"bands{n}"]["device_ms"][k]
                             for n in BAND_COUNTS})
        if not all(oks):
            raise AssertionError(f"a band check failed: {row}")
    emit("bands", ok=True, rows=rows)
    return out


SHARDED_CLI = (  # (label, argv, launches of both runs)
    ("config5_1024", ["--config", "5", "--size", "1024", "--iters", "20"],
     {"fused_vec_step": 20, "fused_vec_render": 1}),
    ("config2_512", ["--config", "2", "--size", "512", "--iters", "50"],
     {"fused_step": 50, "fused_render": 1}),
)
SHARDED_ITERS = 10  # the library runs' steps, 2 bands on the rank


def phase_sharded_main():
    """The sharded inverse render on the one card (see the module's
    docstring, phase 37). Returns each kernel's launches on its sharded
    paths."""
    import dataclasses
    import os
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from reversible_raytracer_tpu_torch import cli, parallel
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.render import render
    from reversible_raytracer_tpu_torch.optim import OptConfig
    from reversible_raytracer_tpu_torch.parallel import shard

    rows, launches, oks = {}, {}, []
    try:
        for label, args, expect in SHARDED_CLI:
            argv = ["invert", *args, "--quiet"]
            plain, lp, wall_p = _counted(lambda: cli.main(argv))
            sharded, ls, wall_s = _counted(lambda: cli.main([*argv, "--sharded"]))
            graphs = [st.captured() for st, _ in shard._SHARD_SCAN_CACHE.values()]
            same = plain["losses"] == sharded["losses"]
            rows[f"invert_{label}"] = dict(
                losses_bit_identical=same, backend=dist.get_backend(), captured=all(graphs),
                loss_first=sharded["losses"][0], loss_last=sharded["losses"][-1],
                wall_seconds=wall_s, plain_wall_seconds=wall_p, loop_seconds=sharded["seconds"],
                plain_loop_seconds=plain["seconds"], launches=ls, plain_launches=lp)
            oks.append(same and all(graphs) and _only(ls, expect) and _only(lp, expect)
                       and dist.get_backend() == "nccl")
            for k, n in ls.items():
                if n:
                    launches.setdefault(k, {})[f"invert_{label}"] = n
        mesh = parallel.make_ray_mesh(2)
        for label, num, size, tau, kernels in BAND_CASES:
            scene, spec, cfg = configs.CONFIGS[num](size=size, device="cuda")
            cfg = dataclasses.replace(cfg, soft_tau=tau)
            target = render(scene, cfg).detach()
            start = configs.perturb(scene, spec, scale=0.05, seed=1)
            ocfg = OptConfig(iters=SHARDED_ITERS, lr=1e-2)
            for impl, names in ((None, kernels[:1]), ("render", kernels[1:])):
                (_, losses), ln, wall = _counted(lambda: parallel.optimize_sharded_scan(
                    start, target, mesh, cfg, spec, ocfg, impl=impl))
                la = losses.cpu().tolist()
                run = f"bands2_{label}_{impl or 'step'}"
                expect = {k: 2 * SHARDED_ITERS for k in names}
                rows[run] = dict(loss_first=la[0], loss_last=la[-1], launches=ln,
                                 wall_seconds=wall)
                oks.append(all(math.isfinite(x) for x in la) and la[-1] < la[0]
                           and _only(ln, expect))
                for k in names:
                    launches.setdefault(k, {})[run] = ln[k]
        dist.destroy_process_group()

        # two ranks over gloo on the one card: the worker
        scene, spec, cfg = configs.config5_many_spheres(size=1024, device="cuda")
        with torch.no_grad():
            one_rank = render(scene, cfg).cpu().numpy()
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        with tempfile.TemporaryDirectory() as outdir:
            cmd = [sys.executable, "-m", "reversible_raytracer_tpu_torch.parallel.worker",
                   f"127.0.0.1:{port}", "2"]
            tail = [outdir, "--backend", "gloo", "--config", "5", "--size", "1024",
                    "--iters", "20"]
            env = {**os.environ, "PYTHONPATH": str(REPO)}
            procs = [subprocess.Popen([*cmd, str(pid), *tail], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for pid in (0, 1)]
            try:
                logs = [p.communicate(timeout=300)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(p.returncode for p in procs):
                raise AssertionError(f"a worker failed: {logs}")
            got = np.load(Path(outdir) / "worker.npz")
            ranks = [json.loads(line) for log in logs for line in log.splitlines()
                     if line.startswith("{")]
            la = got["losses"]
            row = dict(image_bits=bool(np.array_equal(got["image"], one_rank)),
                       scenes_equal=bool(got["scenes_equal"]), loss_first=float(la[0]),
                       loss_last=float(la[-1]), wall_seconds=float(got["wall_s"]),
                       batched_losses=got["batched_losses"].tolist(),
                       batched_grad_norm=float(got["batched_grad_norm"]),
                       ranks=ranks, note="a gloo all-reduce goes through the host: this "
                                         "measures no NCCL scaling")
            rows["worker_gloo_2ranks_config5_1024"] = row
            oks.append(row["image_bits"] and row["scenes_equal"] and la[-1] < la[0]
                       and all(r["backend"] == "gloo" for r in ranks) and len(ranks) == 2
                       and 0.0 < row["batched_grad_norm"] < math.inf)
            for r in ranks:
                for k, n in r.get("launches", {}).items():
                    if n:
                        launches.setdefault(k, {})[f"worker_rank{r['rank']}"] = n
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if not all(oks):
        raise AssertionError(f"a sharded run failed: {rows}")
    emit("sharded_main", ok=True, rows=rows)
    return launches


# ---------------------------------------------------------------------------
# spp 4 with texel grids and with a bounce (phases spp4_texels, spp4_texels_main)
# ---------------------------------------------------------------------------

SPP4_TEX_SIZE = 512
# (label, the case): rows 1-3 on configs 6 (one bounce), 7 (a textured floor)
# and 9 (the sky, one bounce); rows 4-6 on config 10 (the sky, one bounce, 65
# objects), config 8 with a bounce (object texels and a bounce) and the 64
# textured globes; rows 7-8 on config 8 and the sky field at tau 0.08.
SPP4_TEX_FLAT = (("config6_512", 6), ("config7_512", 7), ("config9_512", 9))
SPP4_TEX_VEC = (("config10_512", 10), ("config8_r1_512", 8), ("globes_512", "globes"))
SPP4_TEX_SOFT = (("config8_512_t0.08", 8), ("softenv_512_t0.08", "sky"))
SPP4_TEX_TAU = 0.08
# The steps and render backwards against their plain versions: within this of
# each leaf's scale, or within what float32 determines of a leaf (`_check_grads`).
SPP4_TEX_TOL = 1e-4
# The instances this slice adds (mangled-name parts; ptxas reports them).
SPP4_TEX_INSTANCES = ("flat_step_tex_kernelILi4E", "flat_step_kernelILi4ELi1E",
                      "render_kernelILi4ELi1E", "render_kernel_texILi4E",
                      "vec_step_levels_kernelILi4E", "vec_step_tex_kernelILi4E")


def ptxas_instances(parts):
    """Each kernel function whose mangled name holds one of ``parts``, from
    the build logs' ptxas lines: its registers and spill bytes."""
    import re

    out = {}
    for k in _all_kernels():
        name = None
        for ln in (getattr(k, "build_log", "") or "").splitlines():
            found = re.search(r"Function properties for (\S+)", ln)
            if found:
                name = found.group(1) if any(x in found.group(1) for x in parts) else None
                continue
            if name is None:
                continue
            row = out.setdefault(name, dict(source=k.name))
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if spill:
                row.update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
            used = re.search(r"Used (\d+) registers", ln)
            if used:
                row["registers"] = int(used.group(1))
    return out


def _spp4_soft_case(label, kind, stream):
    """Rows 7 and 8's texel instances at spp 4 (four launches a call at the
    subsamples' offsets) on one case, by phase soft_texture's rules: row 7
    by the oracle rule against its plain version, three calls bit-identical;
    row 8 (autograd of `render`) against the plain render's autograd within
    SPP4_TEX_TOL of each leaf's scale (`_check_grads` with the float64 plain
    render) and its twin within 1e-2, the texels' gradient not 0;
    row 9 refuses spp 4 by name and launches nothing. Then their times on
    the ``_tex_band`` entries, four launches a call, the plain versions',
    the bounds. Returns (case, ok, the kernels line's numbers)."""
    import dataclasses

    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft as fvs
    from reversible_raytracer_tpu_torch.ops.pipeline import SPP_OFFSETS
    from reversible_raytracer_tpu_torch.ops.render import resolve_impl

    scene, _, cfg, start = _soft_tex_case(kind, SPP4_TEX_TAU)
    cfg = dataclasses.replace(cfg, spp=4)
    H, W = cfg.height, cfg.width
    case = dict(impl=resolve_impl(start, cfg))
    ok = [case["impl"] == "cuda_vec_soft"]
    before = fvs.SOFT_RENDER.launches
    imgs = [fvs.render_vec_soft(start, cfg) for _ in range(3)]
    per_call = (fvs.SOFT_RENDER.launches - before) / 3
    img_p = fvs.render_vec_soft_plain(start, cfg)
    torch.cuda.synchronize()
    err = (imgs[0] - img_p).abs()
    r = dict(wrapper_launches_per_call=per_call, frac_bad=float((err > 2e-3).float().mean()),
             mean_err=float(err.mean()), max_abs_err=float(err.max()),
             deterministic=all(torch.equal(imgs[0], i) for i in imgs[1:]),
             finite=bool(torch.isfinite(imgs[0]).all()))
    case["fused_vec_soft_render"] = r
    ok.append(r["frac_bad"] < 1e-3 and r["mean_err"] < 1e-4 and r["deterministic"]
              and r["finite"] and per_call == 4)
    g = _seeded_cotangent(cfg)
    before = fvs.SOFT_RENDER_BWD.launches
    bwds = [_bwd(start, cfg, g) for _ in range(3)]
    per_call = (fvs.SOFT_RENDER_BWD.launches - before) / 3
    r = dict(wrapper_launches_per_call=per_call,
             deterministic=all(torch.equal(fused.flatten_scene(bwds[0]), fused.flatten_scene(b))
                               for b in bwds[1:]),
             texel_grad_nonzero=float((_soft_texel_leaf(bwds[0], start) != 0).float().mean()))
    good = _check_grads(r, "plain", fvs.render_vec_soft_bwd_plain(start, cfg, g), bwds[0],
                        SPP4_TEX_TOL,
                        lambda: fvs.render_vec_soft_bwd_plain(_f64(start), cfg, g))
    good = _check_grads(r, "twin", fvs.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                        bwds[0]) and good
    r["max_abs_err"] = r["plain"]["max_abs_err"]
    case["fused_vec_soft_render_bwd"] = r
    ok.append(good and r["deterministic"] and per_call == 4 and r["texel_grad_nonzero"] > 0)
    before = fvs.SOFT_STEP.launches
    try:
        fvs.loss_grad_vec_soft(start, cfg, imgs[0])
        refused = ""
    except NotImplementedError as exc:
        refused = str(exc)
    case["fused_vec_soft_step"] = dict(refusal=refused)
    ok.append("spp=4 in the soft step" in refused and fvs.SOFT_STEP.launches == before)

    # ---- times: four launches a call on the ``_tex_band`` entries
    glob, sph, rct, stex, rtex = fvs._cuda_inputs(start, cfg)
    geom = fused_vec._geometry(start, cfg) + fused.band_args(cfg)
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), stex.data_ptr(), rtex.data_ptr(),
            *geom)
    sides = fused_vec.tex_levels(start, cfg)[1:]  # ke, ks, kr
    dims = (start.spheres.count, start.rects.count, start.lights.count)
    img = torch.empty((H, W, 3), device="cuda")
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel()
                       + fused_vec.texel_row(start),), device="cuda")
    scratch = torch.empty((fused.host_query(fvs.SOFT_STEP, "rrt_soft_step_tex_scratch_floats",
                                            *dims, H, W, *sides),), device="cuda")
    tau, offs = float(cfg.soft_tau), SPP_OFFSETS[4]

    def render_calls():
        for off in offs:
            fvs.SOFT_RENDER.call("rrt_soft_render_tex_band", *ptrs, *off, tau, *sides,
                                 img.data_ptr(), stream)

    def bwd_calls():
        for off in offs:
            fvs.SOFT_RENDER_BWD.call("rrt_soft_render_bwd_tex_band", *ptrs, *off, tau, *sides,
                                     g.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)

    Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
    n_rows, n_tex = 4 * (Sg + ns_pad * 17 + nr_pad * 22), 4 * fused_vec.texel_row(start)
    nbytes = dict(fused_vec_soft_render=n_rows + n_tex + 4 * H * W * 3,
                  fused_vec_soft_step=2 * (n_rows + n_tex) + 4 * (H * W * 3 + 1),
                  fused_vec_soft_render_bwd=2 * (n_rows + n_tex) + 4 * (H * W * 3 + 1))
    bounds, case["work"] = soft_texture_bounds(start, cfg, nbytes)
    plain = {"fused_vec_soft_render": lambda: fvs.render_vec_soft_plain(start, cfg),
             "fused_vec_soft_render_bwd": lambda: fvs.render_vec_soft_bwd_plain(start, cfg, g)}
    numbers = {}
    for name, fn in (("fused_vec_soft_render", render_calls),
                     ("fused_vec_soft_render_bwd", bwd_calls)):
        dev = device_ms(fn)
        case[name].update(ms=time_ms(fn), device_ms=dev["ms"], launches_per_call=dev["launches"],
                          device=dev, plain_ms=time_ms(plain[name], **VEC_PLAIN_REPS),
                          bound_ms=bounds[name][0], bound_by=bounds[name][1])
        numbers[name] = dict(case=f"{label}_spp4", **{
            k: case[name][k] for k in ("ms", "device_ms", "launches_per_call",
                                       "wrapper_launches_per_call", "max_abs_err", "plain_ms",
                                       "bound_ms", "bound_by")})
    return case, all(ok), numbers


def phase_spp4_texels():
    """Rows 1-8's textured, env and bounce instances at spp 4 at 512^2 (see
    the module's docstring, phase 38). Returns each row's numbers per case."""
    import dataclasses
    import time

    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    saved = {k.name: k.launches for k in _all_kernels()}
    stream = torch.cuda.current_stream().cuda_stream
    rows, oks, numbers = {}, [], {}

    def keep(nums):
        for name, n in nums.items():
            numbers.setdefault(name, {})[n.pop("case")] = n

    t0 = time.perf_counter()
    for label, num in SPP4_TEX_FLAT:  # rows 1-3
        scene, spec, cfg, start = _mirror_case() if num == 6 else _texture_case(num)
        cfg = dataclasses.replace(cfg, spp=4)
        case, ok, got = _flat_rows(scene, start, cfg, SPP4_TEX_TOL)
        S = fused.flatten_scene(start).numel()
        bounds, case["work"] = texture_bounds(start, cfg, S, fused.n_vis_planes(start, cfg))
        nums, timed = _flat_times(case, start, cfg, got.target, got.g, bounds, f"{label}_spp4")
        keep(nums)
        rows[label] = case
        case["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        oks.append(ok and timed)
    for label, kind in SPP4_TEX_VEC:  # rows 4-6
        if kind == "globes":
            scene, spec, cfg, start = _globe_case("globes", 0)
        elif kind == 10:
            scene, spec, cfg, start = _chrome_case(10, SPP4_TEX_SIZE, 0.2, 10)
        else:
            scene, spec, cfg, start = _globe_case(kind, 1)
        cfg = dataclasses.replace(cfg, spp=4)
        case, ok, got = _vec_rows(scene, start, cfg, SPP4_TEX_TOL)
        Sg = fused_vec.flatten_globals(start).numel()
        bounds, uncull, case["work"] = chrome_bounds(start, cfg, Sg,
                                                     fused_vec.n_vis_planes(start, cfg))
        keep(_vec_times(case, start, cfg, got.target, got.g, got.vis, bounds, f"{label}_spp4",
                        uncull))
        rows[label] = case
        case["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        oks.append(ok)
    for label, kind in SPP4_TEX_SOFT:  # rows 7-8
        case, ok, nums = _spp4_soft_case(label, kind, stream)
        keep(nums)
        rows[label] = case
        case["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        oks.append(ok)
    for k in _all_kernels():
        k.launches = saved[k.name]
    regs = ptxas_instances(SPP4_TEX_INSTANCES)
    if not all(oks):
        raise AssertionError(f"a spp-4 textured, env or bounce instance failed a check: {rows}")
    emit("spp4_texels", ok=True, rows=rows, registers=regs)
    return numbers


SPP4_TEX_ITERS = 20
# invert at --spp 4, 512^2: (label, argv after `invert`, the launches each kernel must
# make; the anneal's steps per stage)
SPP4_TEX_RUNS = (
    ("invert_config7_512", ["--config", "7", "--lr", "3e-2", "--perturb", "0.4"],
     {"fused_step": SPP4_TEX_ITERS, "fused_render": 2}),
    ("invert_config9_512", ["--config", "9", "--lr", "3e-2", "--perturb", "0.4"],
     {"fused_step": SPP4_TEX_ITERS, "fused_render": 2}),
    ("invert_config6_512", ["--config", "6", "--lr", "2e-2", "--perturb", "0.3", "--seed", "3"],
     {"fused_step": SPP4_TEX_ITERS, "fused_render": 2}),
    ("invert_config10_512", ["--config", "10", "--lr", "2e-2", "--perturb", "0.2", "--seed",
                             "10"],
     {"fused_vec_step": SPP4_TEX_ITERS, "fused_vec_render": 8}),
    ("invert_config8_r1_512", ["--config", "8", "--reflections", "1", "--lr", "3e-2",
                               "--perturb", "0.4"],
     {"fused_vec_step": SPP4_TEX_ITERS, "fused_vec_render": 8}),
    ("anneal_config8_512", ["--config", "8", "--anneal", "0.08,0.03,0", "--lr", "3e-2",
                            "--perturb", "0.4"],
     {"fused_vec_soft_render": 4 * 2 + 4 * 2 * SPP4_TEX_ITERS,
      "fused_vec_soft_render_bwd": 4 * 2 * SPP4_TEX_ITERS, "fused_step": SPP4_TEX_ITERS,
      "fused_render": 2}),
)
SPP4_TEX_GRAD_CASES = (6, 7, 9)  # optimize(render_fn=render), rows 2 and 3


def phase_spp4_texels_main():
    """The slice's full-width paths at spp 4 (see the module's docstring,
    phase 39). Returns each run's launch counts."""
    import dataclasses

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize
    from reversible_raytracer_tpu_torch.ops.render import render

    out_dir = REPO / "smoke_out"
    rows, counts, oks = {}, {}, []
    for label, argv, expect in SPP4_TEX_RUNS:
        png = out_dir / f"final_spp4_{label}.png"
        full = ["invert", *argv, "--size", str(SPP4_TEX_SIZE), "--spp", "4", "--iters",
                str(SPP4_TEX_ITERS), "--log-every", "1", "--quiet", "-o", str(png)]
        summary, launches, wall = _counted(lambda: cli.main(full))
        if "taus" in summary:  # the anneal: each stage's losses
            la = summary["losses"]
            stages = [la[i * SPP4_TEX_ITERS:(i + 1) * SPP4_TEX_ITERS]
                      for i in range(len(summary["taus"]))]
        else:
            la = [h["loss"] for h in summary["history"]]
            stages = [la]
        row = dict(launches=launches, expected=expect,
                   stage_first_last=[[st[0], st[-1]] for st in stages],
                   stages_fall=[st[-1] < st[0] for st in stages],
                   start_param_err=summary.get("start_param_err"),
                   param_err=summary["param_err"], loop_seconds=summary["seconds"],
                   loop_ms_per_step=summary["seconds"] * 1e3 / len(la), wall_seconds=wall,
                   png_bytes=png.stat().st_size if png.exists() else 0)
        rows[label] = row
        counts[label] = launches
        oks.append(_only(launches, expect) and all(row["stages_fall"]) and png.exists()
                   and all(math.isfinite(x) for x in la))

    # ---- optimize(render_fn=render) at spp 4: rows 2 + 3 on configs 6, 7 and 9,
    # rows 4 + 5 (four launches a call) on the 64 textured globes
    cases = [(f"render_fn_config{num}_512", num) for num in SPP4_TEX_GRAD_CASES]
    cases.append(("render_fn_globes_512", "globes"))
    for label, kind in cases:
        if kind == "globes":
            scene, spec, cfg, start = _globe_case("globes", 0)
            expect = {"fused_vec_render": 4 * SPP4_TEX_ITERS,
                      "fused_vec_render_bwd": 4 * SPP4_TEX_ITERS}
        else:
            scene, spec, cfg, start = _mirror_case() if kind == 6 else _texture_case(kind)
            expect = {"fused_render": SPP4_TEX_ITERS, "fused_render_bwd": SPP4_TEX_ITERS}
        cfg = dataclasses.replace(cfg, spp=4)
        target = render(scene, cfg).detach()
        ocfg = OptConfig(iters=SPP4_TEX_ITERS, lr=2e-2 if kind == 6 else 3e-2)
        losses, launches, wall = _counted(lambda: optimize(
            start, target, spec, cfg, ocfg, log_every=0,
            render_fn=lambda s: render(s, cfg))[2].cpu().tolist())
        rows[label] = dict(launches=launches, expected=expect, first_loss=losses[0],
                           final_loss=losses[-1], wall_seconds=wall)
        counts[label] = launches
        oks.append(_only(launches, expect) and losses[-1] < losses[0]
                   and all(math.isfinite(x) for x in losses))
    if not all(oks):
        raise AssertionError(f"a spp-4 textured, env or bounce run did not run through the "
                             f"expected kernels or did not descend: {rows}")
    emit("spp4_texels_main", ok=True, rows=rows)
    return counts


# ---------------------------------------------------------------------------
# Two and three mirror bounces in rows 1-6
# ---------------------------------------------------------------------------

BOUNCE_SIZE = 512
# (label, config, bounce levels, spp): rows 1-3 on configs 6 and 9, rows 4-6 on
# config 10 (``_levels`` with the env) and config 8's globe with mirror
# coefficients (``_tex``); at spp 4 the instances that `invert --reflections 2
# --spp 4` runs on configs 6 and 10, and config 6's at three levels (the other
# spp-4 instances are held at 64^2 by tests/test_torch_kernels.py)
BOUNCE_CASES = (("config6_r2", 6, 2, 1), ("config6_r3", 6, 3, 1), ("config9_r2", 9, 2, 1),
                ("config10_r2", 10, 2, 1), ("config10_r3", 10, 3, 1),
                ("config8_mirrors_r2", 8, 2, 1), ("config6_r2_spp4", 6, 2, 4),
                ("config6_r3_spp4", 6, 3, 4), ("config10_r2_spp4", 10, 2, 4))
# The instances this slice adds (mangled-name parts: REFL 2 or 3 after the
# SPP, or first), in the hard families' sources.
BOUNCE_INSTANCES = ("ELi2E", "ELi3E", "kernelILi2E", "kernelILi3E")


def with_mirrors(scene, sphere_m=0.3, rect_m=0.4):
    """``scene`` with every sphere's mirror coefficient ``sphere_m`` and
    every rect's ``rect_m``: config 8's globe seen in its floor and the
    floor in it, so that its texel grid is sampled at every bounce level."""
    import dataclasses

    import torch

    sp, rc = scene.spheres, scene.rects
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(sp, material=dataclasses.replace(
            sp.material, mirror=torch.full_like(sp.material.mirror, sphere_m))),
        rects=dataclasses.replace(rc, material=dataclasses.replace(
            rc.material, mirror=torch.full_like(rc.material.mirror, rect_m))))


def _bounce_case(num, refl, spp):
    """(scene, spec, cfg, start) of a case of phase bounces at BOUNCE_SIZE^2:
    the starts of phases mirror (config 6), texture (config 9), chrome
    (config 10) and globes (config 8, with `with_mirrors`)."""
    import dataclasses

    if num == 6:
        scene, spec, cfg, start = _mirror_case(BOUNCE_SIZE)
    elif num == 9:
        scene, spec, cfg, start = _texture_case(9, BOUNCE_SIZE)
    elif num == 10:
        scene, spec, cfg, start = _chrome_case(10, BOUNCE_SIZE, 0.2, 10)
    else:
        scene, spec, cfg, start = _globe_case(8, refl, BOUNCE_SIZE)
        scene, start = with_mirrors(scene), with_mirrors(start)
    return scene, spec, dataclasses.replace(cfg, reflections=refl, spp=spp), start


def phase_bounces():
    """Rows 1-6 at two and three bounce levels, 512^2 (see the module's
    docstring, phase 40). Returns each row's numbers per case."""
    import time

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    saved = {k.name: k.launches for k in _all_kernels()}
    rows, oks, numbers = {}, [], {}
    t0 = time.perf_counter()
    for label, num, refl, spp in BOUNCE_CASES:
        scene, spec, cfg, start = _bounce_case(num, refl, spp)
        if num in (6, 9):  # rows 1-3
            case, ok, got = _flat_rows(scene, start, cfg, SPP4_TEX_TOL)
            S = fused.flatten_scene(start).numel()
            bounds, case["work"] = texture_bounds(start, cfg, S, fused.n_vis_planes(start, cfg))
            nums, timed = _flat_times(case, start, cfg, got.target, got.g, bounds, label)
            ok = ok and timed
        else:  # rows 4-6
            case, ok, got = _vec_rows(scene, start, cfg, SPP4_TEX_TOL)
            Sg = fused_vec.flatten_globals(start).numel()
            bounds, uncull, case["work"] = chrome_bounds(start, cfg, Sg,
                                                         fused_vec.n_vis_planes(start, cfg))
            nums = _vec_times(case, start, cfg, got.target, got.g, got.vis, bounds, label,
                              uncull)
        for name, n in nums.items():
            numbers.setdefault(name, {})[n.pop("case")] = n
        rows[label] = case
        case["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        oks.append(ok)
    for k in _all_kernels():
        k.launches = saved[k.name]
    regs = {name: r for name, r in ptxas_instances(BOUNCE_INSTANCES).items()
            if "soft" not in r["source"]}
    if not all(oks):
        raise AssertionError(f"an instance with two or three bounce levels failed a check: "
                             f"{rows}")
    emit("bounces", ok=True, rows=rows, registers=regs)
    return numbers


BOUNCE_ITERS = 20
# The entry points at two and three bounce levels, 512^2: (label, argv, the
# launches each kernel must make; the mirror coefficients' RMS error must end
# below this, or None)
BOUNCE_RUNS = (
    ("render_config6_r2", ["render", "--config", "6", "--reflections", "2"],
     {"fused_render": 1}, None),
    ("render_config6_r3", ["render", "--config", "6", "--reflections", "3"],
     {"fused_render": 1}, None),
    ("invert_config6_r2", ["invert", "--config", "6", "--reflections", "2", "--perturb", "0.3",
                           "--lr", "2e-2", "--seed", "3", "--iters", str(MIRROR_ITERS)],
     {"fused_step": MIRROR_ITERS, "fused_render": 2}, 1e-3),
    ("invert_config6_r2_48", ["invert", "--config", "6", "--reflections", "2", "--size", "48",
                              "--perturb", "0.3", "--lr", "2e-2", "--seed", "3", "--iters",
                              str(MIRROR_ITERS)],
     {"fused_step": MIRROR_ITERS, "fused_render": 2}, 1e-3),
    ("invert_config9_r2", ["invert", "--config", "9", "--reflections", "2", "--perturb", "0.4",
                           "--lr", "3e-2", "--iters", str(BOUNCE_ITERS)],
     {"fused_step": BOUNCE_ITERS, "fused_render": 2}, None),
    ("invert_config10_r2", ["invert", "--config", "10", "--reflections", "2", "--perturb", "0.2",
                            "--lr", "2e-2", "--seed", "10", "--iters", str(BOUNCE_ITERS)],
     {"fused_vec_step": BOUNCE_ITERS, "fused_vec_render": 2}, None),
    ("invert_config8_r2", ["invert", "--config", "8", "--reflections", "2", "--perturb", "0.4",
                           "--lr", "3e-2", "--iters", str(BOUNCE_ITERS)],
     {"fused_vec_step": BOUNCE_ITERS, "fused_vec_render": 2}, None),
    ("invert_config6_r2_spp4", ["invert", "--config", "6", "--reflections", "2", "--spp", "4",
                                "--perturb", "0.3", "--lr", "2e-2", "--seed", "3", "--iters",
                                str(BOUNCE_ITERS)],
     {"fused_step": BOUNCE_ITERS, "fused_render": 2}, None),
    ("invert_config10_r2_spp4", ["invert", "--config", "10", "--reflections", "2", "--spp", "4",
                                 "--perturb", "0.2", "--lr", "2e-2", "--seed", "10", "--iters",
                                 str(BOUNCE_ITERS)],
     {"fused_vec_step": BOUNCE_ITERS, "fused_vec_render": 8}, None),
)


def phase_bounces_main():
    """The entry points at two and three bounce levels (see the module's
    docstring, phase 41). Returns each run's launch counts."""
    import dataclasses

    from reversible_raytracer_tpu_torch import cli
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize
    from reversible_raytracer_tpu_torch.ops.render import render

    out_dir = REPO / "smoke_out"
    rows, counts, oks = {}, {}, []
    for label, argv, expect, crit in BOUNCE_RUNS:
        png = out_dir / f"bounces_{label}.png"
        full = [*argv, "-o", str(png)]
        if argv[0] == "invert":
            full += ["--log-every", "1", "--quiet"]
        summary, launches, wall = _counted(lambda: cli.main(full))
        row = dict(launches=launches, expected=expect, wall_seconds=wall,
                   png_bytes=png.stat().st_size if png.exists() else 0)
        ok = _only(launches, expect) and png.exists()
        if argv[0] == "invert":
            la = [h["loss"] for h in summary["history"]]
            row.update(first_loss=la[0], final_loss=la[-1],
                       start_param_err=summary["history"][0]["param_err"],
                       param_err=summary["param_err"], loop_seconds=summary["seconds"],
                       loop_ms_per_step=summary["seconds"] * 1e3 / len(la))
            ok = ok and la[-1] < la[0] and all(math.isfinite(x) for x in la)
            if crit is not None:
                row["param_err_below"] = crit
                ok = ok and summary["param_err"] < crit
        rows[label] = row
        counts[label] = launches
        oks.append(ok)

    # ---- optimize(render_fn=render) at two bounce levels: rows 2 + 3 on config 6,
    # rows 4 + 5 on config 10
    for label, num, expect in (
            ("render_fn_config6_r2", 6,
             {"fused_render": BOUNCE_ITERS + 1, "fused_render_bwd": BOUNCE_ITERS}),
            ("render_fn_config10_r2", 10,
             {"fused_vec_render": BOUNCE_ITERS + 1, "fused_vec_render_bwd": BOUNCE_ITERS})):
        scene, spec, cfg, start = _bounce_case(num, 2, 1)
        ocfg = OptConfig(iters=BOUNCE_ITERS, lr=2e-2)

        def run(scene=scene, spec=spec, cfg=cfg, start=start, ocfg=ocfg):
            target = render(scene, cfg).detach()
            return optimize(start, target, spec, cfg, ocfg, log_every=0,
                            render_fn=lambda s: render(s, cfg))[2].cpu().tolist()

        losses, launches, wall = _counted(run)
        rows[label] = dict(launches=launches, expected=expect, first_loss=losses[0],
                           final_loss=losses[-1], wall_seconds=wall)
        counts[label] = launches
        oks.append(_only(launches, expect) and losses[-1] < losses[0]
                   and all(math.isfinite(x) for x in losses))
    oks.append(_refusals((
        ("render_config6_r4", ["render", "--config", "6", "--size", "64", "--reflections", "4",
                               "-o", str(out_dir / "refused.png")], "reflections > 3", {}),), rows))
    if not all(oks):
        raise AssertionError(f"a run at two or three bounce levels did not run through the "
                             f"expected kernels, did not descend or did not recover: {rows}")
    emit("bounces_main", ok=True, rows=rows)
    return counts


def kernel_status():
    """Each kernel's status as PERF.md's table of TPU kernels records it
    (ported, and redesigned, and when), by the CUDA source in its row."""
    import re

    status = {}
    perf = REPO / "PERF.md"
    for line in perf.read_text().splitlines() if perf.exists() else []:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        found = re.search(r"csrc/(\w+)\.cu", line)
        if len(cells) > 3 and cells[0].isdigit() and found:
            status[found.group(1)] = re.sub(r" \(.*\)$", "", cells[2])
    return status


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (REPO / "reversible_raytracer_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    global device_ms, time_ms
    from tools.kernel_timing import device_ms, time_ms  # the repo's, beside this script

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = run_phase("device", phase_device)
    contracted = run_phase("build", phase_build)
    render_err = run_phase("render", phase_render)
    start, target, cfg, step_err, g_plain = run_phase("step", phase_step)
    launches = run_phase("main", phase_main)
    kernels = run_phase("times", phase_times, (start, target, cfg), launches, render_err, step_err)
    run_phase("fmad", phase_fmad, contracted, (start, target, cfg), g_plain)
    vec_render_err, targets = run_phase("vec_render", phase_vec_render)
    vec_step_err = run_phase("vec_step", phase_vec_step, targets)
    vec_launches = run_phase("vec_main", phase_vec_main)
    vt = run_phase("vec_times", phase_vec_times)["config5_1024"]
    soft_render_err = run_phase("soft_render", phase_soft_render)
    soft_step_err = run_phase("soft_step", phase_soft_step)
    anneal_launches = run_phase("anneal_main", phase_anneal_main)
    st = run_phase("soft_times", phase_soft_times)["config5_512_t0.08"]
    grad_err = run_phase("render_grad", phase_render_grad)
    grad_launches = run_phase("render_grad_main", phase_render_grad_main)
    gt = run_phase("render_grad_times", phase_render_grad_times)
    run_phase("loop", phase_loop)
    checker = run_phase("checker", phase_checker)
    checker_runs = run_phase("checker_main", phase_checker_main)
    spp4 = run_phase("spp4", phase_spp4)
    spp4_runs = run_phase("spp4_main", phase_spp4_main)
    mirror = run_phase("mirror", phase_mirror)
    mirror_runs = run_phase("mirror_main", phase_mirror_main)
    texture = run_phase("texture", phase_texture)
    texture_runs = run_phase("texture_main", phase_texture_main)
    chrome = run_phase("chrome", phase_chrome)
    chrome_runs = run_phase("chrome_main", phase_chrome_main)
    globes = run_phase("globes", phase_globes)
    globes_runs = run_phase("globes_main", phase_globes_main)
    soft_tex = run_phase("soft_texture", phase_soft_texture)
    soft_tex_runs = run_phase("soft_texture_main", phase_soft_texture_main)
    restart_runs = run_phase("restarts", phase_restarts)
    restart_runs.update(run_phase("restarts_main", phase_restarts_main))
    bands = run_phase("bands", phase_bands)
    sharded = run_phase("sharded_main", phase_sharded_main)
    spp4_tex = run_phase("spp4_texels", phase_spp4_texels)
    spp4_tex_runs = run_phase("spp4_texels_main", phase_spp4_texels_main)
    bounces = run_phase("bounces", phase_bounces)
    bounce_runs = run_phase("bounces_main", phase_bounces_main)
    src = "reversible_raytracer_tpu_torch/ops/kernels/csrc/"
    kernels += [
        dict(name="fused_vec_step", route="cuda", source=src + "fused_vec_step.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec.py:979",
             launches=vec_launches["fused_vec_step"], max_abs_err=vec_step_err,
             ms=vt["step_ms"], plain_ms=vt["step_plain_ms"], bound_ms=vt["step_bound"][0],
             bound_by=vt["step_bound"][1], library_ms=None),
        dict(name="fused_vec_render", route="cuda", source=src + "fused_vec_render.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec.py:897",
             launches=vec_launches["fused_vec_render"], max_abs_err=vec_render_err,
             ms=vt["render_ms"], plain_ms=vt["render_plain_ms"], bound_ms=vt["render_bound"][0],
             bound_by=vt["render_bound"][1], library_ms=None,
             device_ms=vt["render_device"]["ms"],
             launches_per_call=vt["render_device"]["launches"]),
        dict(name="fused_vec_soft_step", route="cuda", source=src + "fused_vec_soft_step.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:547",
             launches=anneal_launches["fused_vec_soft_step"], max_abs_err=soft_step_err,
             ms=st["step_ms"], plain_ms=st["step_plain_ms"], bound_ms=st["step_bound"][0],
             bound_by=st["step_bound"][1], library_ms=None),
        dict(name="fused_vec_soft_render", route="cuda", source=src + "fused_vec_soft_render.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:494",
             launches=anneal_launches["fused_vec_soft_render"], max_abs_err=soft_render_err,
             ms=st["render_ms"], plain_ms=st["render_plain_ms"], bound_ms=st["render_bound"][0],
             bound_by=st["render_bound"][1], library_ms=None,
             device_ms=st["render_device"]["ms"],
             launches_per_call=st["render_device"]["launches"]),
    ]
    for label, family, *_ in GRAD_CASES:
        name = BWD_NAMES[family]
        kernels.append(dict(
            name=name, route="cuda", source=src + f"{name}.cu", replaces=BWD_REPLACES[family],
            launches=grad_launches[label][name], max_abs_err=grad_err[family],
            ms=gt[label]["bwd_ms"], plain_ms=gt[label]["plain_ms"],
            bound_ms=gt[label]["bound"][0], bound_by=gt[label]["bound"][1], library_ms=None,
            device_ms=gt[label]["bwd_device"]["ms"],
            launches_per_call=gt[label]["bwd_device"]["launches"]))
    for label, family, *_ in GRAD_CASES:  # the forwards' launches on the render_fn path
        for k in kernels:
            if k["name"] == FWD_NAMES[family]:
                k["launches_render_fn"] = grad_launches[label][k["name"]]
    for k in kernels:  # the soft checker's instances at config 4 (phases checker, checker_main)
        if k["name"] in checker:
            t = checker[k["name"]]
            k["checker"] = dict(case=f"config4_{CHECKER_SIZE}_t{CHECKER_TAU}_c{CHECKER_CTAU}",
                                launches=checker_runs["anneal_512"]["launches"][k["name"]],
                                max_abs_err=t["max_abs_err"], ms=t["ms"],
                                device_ms=t["device"]["ms"],
                                launches_per_call=t["device"]["launches"],
                                plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                                bound_by=t["bound"][1])
    spp4_launches = {}  # each kernel's launches on its spp-4 CLI path (phase spp4_main)
    for label, *_ in SPP4_RUNS:
        for name, n in spp4_runs[label].items():
            if n and name not in spp4_launches:
                spp4_launches[name] = dict(run=label, launches=n)
    for k in kernels:  # rows 1-8 at spp 4 (phases spp4, spp4_main)
        if k["name"] in spp4:
            k["spp4"] = dict(**spp4[k["name"]], launches=spp4_launches.get(k["name"]))
    for k in kernels:  # rows 1-3 with a bounce level (phases mirror, mirror_main)
        if k["name"] in mirror:
            run = "render_fn_512" if k["name"] == "fused_render_bwd" else "invert_512"
            k["mirror"] = dict(**mirror[k["name"]], launches=mirror_runs[run][k["name"]])
            if k["name"] == "fused_render":
                k["mirror"]["launches_render_fn"] = mirror_runs["render_fn_512"][k["name"]]
    for k in kernels:  # rows 1-3's textured instances (phases texture, texture_main)
        for case, nums in texture.get(k["name"], {}).items():
            num = case[len("config")]
            run = "render_fn" if k["name"] == "fused_render_bwd" else "invert"
            k.setdefault("texture", {})[case] = dict(
                **nums, launches=texture_runs[f"{run}_config{num}_{TEX_SIZE}"][k["name"]])
            if k["name"] == "fused_render":
                k["texture"][case]["launches_render_fn"] = texture_runs[
                    f"render_fn_config{num}_{TEX_SIZE}"][k["name"]]
    for k in kernels:  # rows 4-6's env and bounce instances (phases chrome, chrome_main)
        for case, nums in chrome.get(k["name"], {}).items():
            run, by_render = {"config10_512": ("invert_config10_512", "render_fn_config10_512"),
                              "config5r_1024": ("invert_config5_reflections_1024",
                                                "render_fn_config5_reflections_1024")}[case]
            if k["name"] == "fused_vec_render_bwd":
                run = by_render
            k.setdefault("chrome", {})[case] = dict(**nums, launches=chrome_runs[run][k["name"]])
            if k["name"] == "fused_vec_render":
                k["chrome"][case]["launches_render_fn"] = chrome_runs[by_render][k["name"]]
    for k in kernels:  # rows 4-6's textured instances (phases globes, globes_main)
        for case, nums in globes.get(k["name"], {}).items():
            run, by_render = {"globes_512": ("scan_globes_r0_512", "render_fn_globes_r0_512"),
                              "globes_r1_512": ("scan_globes_r1_512", "render_fn_globes_r1_512"),
                              "config7_r1_512": ("invert_config7_r1_512", None),
                              "config8_r1_512": ("invert_config8_r1_512", None)}[case]
            if k["name"] == "fused_vec_render_bwd":
                run = by_render
            k.setdefault("globes", {})[case] = dict(
                **nums, launches=globes_runs[run][k["name"]] if run else None, run=run)
            if k["name"] == "fused_vec_render" and by_render:
                k["globes"][case]["launches_render_fn"] = globes_runs[by_render][k["name"]]
    for k in kernels:  # rows 7-9's texel instances (phases soft_texture, soft_texture_main)
        for case, nums in soft_tex.get(k["name"], {}).items():
            run = {"softtex_512": "anneal_globes_512", "softenv_512": "anneal_sky_512",
                   "config7_512": "invert_config7_anneal_512",
                   "config8_512": "invert_config8_anneal_512",
                   "config9_r0_512": "invert_config9_anneal_512"}[case]
            if k["name"] == "fused_vec_soft_render_bwd":
                run = f"render_fn_globes_{SOFT_TEX_SIZE}" if case == "softtex_512" else None
            k.setdefault("soft_texture", {})[case] = dict(
                **nums, launches=soft_tex_runs[run][k["name"]] if run else None, run=run)
            if k["name"] == "fused_vec_soft_render" and case == "softtex_512":
                k["soft_texture"][case]["launches_render_fn"] = soft_tex_runs[
                    f"render_fn_globes_{SOFT_TEX_SIZE}"][k["name"]]
    for k in kernels:  # each kernel's launches on the restarts' paths (phases restarts, restarts_main)
        runs = {label: n[k["name"]] for label, n in restart_runs.items() if n.get(k["name"])}
        if runs:
            k["restarts"] = runs
    for k in kernels:  # every row's bands (phase bands) and its sharded launches (sharded_main)
        k["bands"] = dict(**bands[k["name"]], launches_sharded=sharded.get(k["name"], {}))
    for k in kernels:  # rows 1-8 at spp 4 with texels and a bounce (spp4_texels, _main)
        for case, nums in spp4_tex.get(k["name"], {}).items():
            runs = {label: n[k["name"]] for label, n in spp4_tex_runs.items()
                    if n.get(k["name"])}
            k.setdefault("spp4_texels", {})[case] = dict(**nums, launches=runs)
    for k in kernels:  # rows 1-6 at two and three bounce levels (bounces, bounces_main)
        runs = {label: n[k["name"]] for label, n in bounce_runs.items() if n.get(k["name"])}
        for case, nums in bounces.get(k["name"], {}).items():
            k.setdefault("bounces", {})[case] = dict(**nums, launches=runs)
    status = kernel_status()
    for k in kernels:
        k["status"] = status.get(k["name"], "not recorded")
    emit("timing", ok=True, seconds=PHASE_SECONDS)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
