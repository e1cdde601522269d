"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:
  1. device   — require CUDA, print ``nvidia-smi`` name and power limit;
  2. build    — build every kernel of the served paths from
                ``dmfusion_torch/csrc`` (nvcc, sm_90a), print the seconds;
  3. kernels  — hold each kernel against its plain PyTorch version at the
                main path's shapes (image6 synthetic scene, patch 16): every
                family call of the window gather, as a one-stream, a dual
                (MS, PAN), a tri (MS, PAN and the seeded IHS MSPAN scene,
                whose build on the card is timed) and a quad gather (the
                two-stage solver's four MS-geometry streams, from seeded
                stage-1 scenes), must be bit-equal with exactly one launch
                (``tools/gather_probe.check_calls``): f32 and bf16 scenes,
                B 4096, the ragged 4093 and 256, corner anchors, negative
                ids and ids past the scene, shards of a stand-in mesh of 2
                and 3 ranks at B 4160 (a padded tail), and clamped explicit
                starts; print the kernel's registers and spills (``nvcc
                -Xptxas -v``); time the one-stream, dual and quad calls
                from the flat ids (the kernel, the plain version and one
                PyTorch indexing call a stream, in turns; the dual and
                quad buckets also by the profiler's device time), and
                compute the bytes bound;
  4. serving  — gmfnet at width 64, bf16 compute, f32 scene, seeded
                weights, saved and loaded as an artifact, serving
                bucket-4096 requests through ``ScenePredictor``; the
                launch counts must show the gather ran once per bucket and
                the fused norm (B5) 13 times a bucket, none bypassed;
                predictions must equal a run with the plain gather; the
                norm blocks must hand bf16 on, as flax's
                GroupNorm(dtype=bf16) does; the bf16 logits on the card
                must lie within BF16_ATOL of the f32 logits of the same
                weights on the CPU,
                and f32 logits on the card (TF32 off) within 1e-3;
  5. pool     — the phase window-pool must be bit-equal to its plain
                version at the image6 w32 shape (bf16 and f32), at an
                odd-output geometry, at a wide one (4C = 256, patch 32),
                at patch 34 (the shared body) and at 24-byte pixels
                (4C = 12, bf16); print the launch plan; time the kernel,
                the plain version and one ``avg_pool2d`` call on the
                full-resolution map, and compute the bytes bound;
  6. dense    — dense_fusion at width 32, patch 16, bf16 compute, f32
                scene, seeded weights, saved and loaded as an artifact,
                rendering the whole image6 class map through
                ``ScenePredictor.class_map()``: 2 warm-up and 10 timed
                maps, one pool launch per map; the map with the plain pool
                on the card must be equal; ``evaluate()``; a map in 4 row
                bands (4 launches, argmax agreement >= 0.999 with the
                whole map); on a 96x96 crop, bf16 card logits within
                DENSE_BF16_ATOL of f32 CPU logits and f32 card logits
                (TF32 off) within 1e-3; a profile of 2 maps;
  7. train    — the default training run through the CLI's ``main``:
                gmfnet w64, patch 16, batch 256, Adam, bf16 compute, f32
                image6 scene, 2 epochs and test (no color); two finite
                epoch losses, the second below the first; a test matrix
                that sums to the test split and OA >= 0.5; every file
                written; B1 launched once per gathered batch (train, val
                and test), the count computed from the split sizes; B1
                bit-equal to the plain gather at B 256 on a shuffled
                train batch and on the padded last one; the val
                confusion through B1 equals the one through the plain
                gather, and the best weights reloaded from their file by a
                fresh solver give it again; three Adam steps from seeded
                weights: f32 card losses (TF32 off) within 1e-3 of the
                CPU's, bf16 within TRAIN_BF16_ATOL of f32; times of the
                epochs, 20 train steps, val and test, a profile of
                the 20 steps (device ops, busy and idle share), the host
                ops of 5 more, and B1 at B 256; the solver and its run
                dir are kept for the diagnostics phase;
  8. train_dense — dense_fusion trained through the CLI's ``main`` as
                ``python -m dmfusion_torch.cli --set model_name=dense_fusion
                model_width=32 data_city=image6 epoch=2 time=1
                color.index=1`` (w32, patch 16, batch 256, Adam, bf16
                compute, f32 image6 scene): epochs [0, 1] with finite
                losses; the remat probe's decision and peak logged; a test
                matrix that sums to the test split and OA >= 0.5; every
                file written; B2 launched exactly 4 times (2 val maps, the
                test map, the color map) and never by a train step; with
                the best weights, the logits and class maps through B2
                equal to those with the plain pool; on a 200x200 crop of
                the scene, three Adam steps: f32 card losses (TF32 off)
                within 1e-3 of the CPU's, bf16 within DENSE_TRAIN_BF16_ATOL
                of f32, a full-batch step finite with no B2 launch, a step
                streamed in 2 bands within 1e-3 of the whole pass; bf16 vs
                f32 logits maps of the trained weights (argmax agreement at
                least 0.99); times of the epochs, 20 train steps, val, test
                and color, a profile of 5 steps and the operators
                behind the device time of 2 more;
  9. train_conv — gmfnet_conv trained through the CLI's ``main`` as
                ``python -m dmfusion_torch.cli --set model_name=gmfnet_conv
                patch_size=47 data_city=image6 epoch=2 time=1
                color.index=1`` (w64, batch 256, Adam, bf16 compute, f32
                image6 scene): epochs [0, 1] with finite losses; a test
                matrix that sums to the test split and OA >= 0.5; every
                file written; B1 launched once per train and val batch
                (the count computed from the split sizes) and never by
                test and color, which render one class map each by the
                shift-and-stitch route; every B1 family call bit-equal
                to its plain version at patch 47 with one launch (f32 and
                bf16 scenes, B 4096, 4093 and 256, wild ids, shards,
                clamped starts; the dual call at the edge anchors) and
                the dual call timed there; with the best
                weights, on a 200x200 anchor crop at f32 (TF32 off), the
                map route's logits within 1e-3 of the window route's and
                of the CPU's; over 32,768 anchors of the scene at bf16
                (``tools/convmap_ab.run()``), the two routes' argmax
                agreement at least 0.99, with the map's time (median of
                10 after 2), anchors/s and peak, and the per-anchor
                route's anchors/s over 98,304 anchors; a map in 3 bands
                equal to the whole map in f32 (TF32 off), and in bf16 at
                least 0.999 of its pixels; ``python -m dmfusion_torch.export
                --map`` of the best weights, served by ``ScenePredictor``,
                equal to the solver's map, ``evaluate()``, and ``predict``
                refused; times of the epochs, 20 train steps, val, test
                and color, a profile of the 20 steps and of one map;
  10. strip   — the strip gather must be bit-equal to its plain version
                at the strip bench's shape (98,304 image6 raster anchors,
                strips of 128, patch 16) in f32 and bf16, and at edge
                strips past the right and the bottom edge of the view
                (zeros) with starts off any alignment; two launches per
                dual strip call; then ``strip_gather_bench.run()`` on the
                card (bit-equal to the per-anchor gather, timed against
                it); time the kernel, the plain version and one indexing
                call per view, and compute the bytes bound;
  11. conv    — the built kernel's SASS must hold wgmma (HGMMA) and
                bulk copies (UBLKCP) and no mma.sync (HMMA); the 3x3
                128->128 bf16 conv must be equal or one bf16 ulp apart
                (``ulp_report``) from its plain version and from
                ``F.conv2d`` at odd shapes and at shapes on and off the
                8 x 32 tile, and equal the closed form of a constant-weight
                case, one launch per pass; then ``conv_kernel_probe.run()``
                at the dense trunk's (1008, 1058, 128), which checks the
                same way and times the kernel, the plain version and
                ``F.conv2d``; the bound is the operations' at dense bf16
                peak;
  12. train_tri — tri_net trained through the CLI's ``main`` as ``python -m
                dmfusion_torch.cli --set model_name=tri_net data_city=image6
                epoch=2 time=1 color.index=0 test.index=0`` (w64, patch
                16, batch 256, Adam, bf16 compute, f32 image6 scene; no
                test and no color: train_dp_streams tests tri_net): two
                finite epoch losses, the second below the first; every
                file written; MSPAN the shape of the padded PAN, float32,
                within 1e-5 of it (equal in exact arithmetic); B1 launched once per gathered batch (train and val), the count
                computed from the split sizes;
                the val
                confusion through B1 equal to the one through the plain
                gather; three Adam steps from seeded weights: f32 card
                losses (TF32 off) within 1e-3 of the CPU's, bf16 within
                TRAIN_BF16_ATOL of f32; ``python -m dmfusion_torch.export``
                of the best weights served by ``ScenePredictor`` (MSPAN
                rebuilt from the manifest's seed, equal to the solver's):
                the served labels of 8 requests of 4096 labeled anchors
                equal the solver's per-anchor prediction (its color route)
                there, one launch a request; ``--map`` refused; times of
                the epochs, 20 train steps, val, test and the requests, a
                profile of the 20 steps, and
                the tri bucket (one launch) at B 4096 and B 256 beside its
                bytes bound;
  13. train_quad — stage 2 of the two-stage solver through the CLI's
                ``main`` as ``python -m dmfusion_torch.cli --solver twostage
                --set model_name=dqtl dqtl.pre_trained=1 data_city=image6
                epoch=2 time=1 color.index=0 test.index=0`` (dqtl w64,
                patch 16, batch 256, Adam, qua_loss, bf16 compute, four f32
                image6 streams; no test and no color: train_gan tests
                dqtl), on seeded image6-shaped stage-1 scenes written first
                (``msgan.npy`` near pan2ms(PAN), ``pangan.npy`` near MS,
                each plus seeded noise): two finite epoch losses, the
                second below the first; every file written; B1 launched once per gathered batch (trimmed train batches and val),
                the count computed from the split sizes; B1 bit-equal to
                ``gather_quad`` at B 256 on a shuffled train batch and on the
                padded last one; the five val confusions through B1 equal
                to those through the plain gather; three Adam steps on
                qua_loss from seeded weights: f32 card losses (TF32 off)
                within 1e-3 of the CPU's, bf16 within QUAD_TRAIN_BF16_ATOL
                of f32; ``python -m dmfusion_torch.export`` of the best
                weights served by ``ScenePredictor`` with ``gan_dir`` (the
                streams equal the solver's): 8 requests of 4096 labeled
                anchors, one launch a request, labels equal to the solver's
                per-anchor prediction (its color route) and to the plain
                gather's on the card; the three serving refusals (no
                ``gan_dir``, a missing GAN scene, one of another shape);
                times of the epochs, 20 train steps (and their profile),
                val and the requests (the quad bucket is timed in the
                kernels phase);
  14. train_gan — stage 1 and stage 2 of the two-stage solver through the
                CLI's ``main`` as ``python -m dmfusion_torch.cli --solver
                twostage --set model_name=dqtl dqtl.pre_trained=0
                dqtl.save_model=1 dqtl.epochs=3 data_city=image6 epoch=2
                time=1 color.index=0``: the GAN quartet at the config's
                stage-1 widths (gan_width 32, pic 128, batch 4, 68 steps an
                epoch over image6's 272 tiles, bf16; 3 epochs of the
                config's 10), then dqtl (w64, patch 16,
                batch 256, bf16) for two epochs and its test on the four
                streams built from stage 1's scenes: three stage-1 epochs with
                finite d and g losses; msgan.npy and pangan.npy of the
                scene's shape, finite, within [0, 1], equal to the solver's
                scenes; the four checkpoints, both renders and the four
                sample grids written; the stage-2 streams built from them;
                test matrices that sum to the test split, the fused and the
                MS stream's test OA at least 0.5, a ``streams`` sheet (these
                checks stand for train_quad's and train_dp_streams',
                whose runs do not test); B1 launched once per gathered batch
                (trimmed train batches, val and test), the count computed
                from the split sizes, and bit-equal to ``gather_quad`` on the
                stage-1 streams at a B 256 train and a B 4096 test batch; a
                fresh solver with ``dqtl.load_model=1`` loads the four files,
                whose state equals the live nets' and whose generators make
                the same fakes; three GAN steps at gan_width 32 on tiles
                cropped to 64, two a step, from seeded weights and noise:
                f32 card losses (TF32 off) within 1e-3 of the CPU's, bf16
                within GAN_BF16_RTOL of f32, relative; ``python -m
                dmfusion_torch.export`` of the best weights served with
                stage 1's own ``dqtl_weights/``: 2 requests of 4096, one
                launch each, equal to the solver's predictions; times of
                stage 1's set-up (pan2ms and tiling, sample grids, scenes and
                renders), its epochs, 20 more steps (ms a step, tiles/s, busy
                share, a profile by operator), stage 2's epochs and test,
                and the phase;
  15. zoo     — resnet18 (width 32), cross_net and vision_transformer (the
                config's ``trans``: embed 96, depth 2, 3 heads, patch 1),
                swin_transformer and swin_T_dual (``trans``: embed 96,
                window 2, depths [2, 4], heads [3, 3]) and ct_lstm (width
                64) at bf16 from seeded weights: 20 train steps of 256
                through ``DualPrograms`` (B1 once a step, counted; the loss
                falls), then a ``save_artifact`` -> ``load_artifact`` ->
                ``ScenePredictor`` round trip serving 8 requests of 4096
                (B1 once a request; the widths read back from the
                artifact's tree); with the trained weights, on 256
                anchors, bf16 card logits within ZOO_BF16_ATOL of f32 CPU
                logits and f32 card logits (TF32 off) within 1e-3; bf16 vs
                f32 card argmax agreement at least ZOO_AGREE_MIN (a floor
                of its own for swin_transformer, whose logits still sit at
                the class prior) over a request of 4096; times of a step
                and a request, peak memory;
  16. train_ct — ct_lstm trained through the CLI's ``main`` as ``python -m
                dmfusion_torch.cli --set model_name=ct_lstm epoch=2 time=1
                color.index=0 test.index=0 proof.index=1`` (w64, patch
                16, batch 256, Adam, bf16 compute, f32 image6 scene; the
                contourlet transform in f32 inside the model): epochs [0,
                1] with finite losses; the last val OA at least CT_OA_MIN;
                the checkpoints, records and the four proof grids written;
                B1 launched once per gathered batch (train and val; test
                and color are off), the count computed from the split
                sizes; the contourlet of a request batch's windows (4096 MS
                and PAN) on the card within 1e-5 of the CPU's with TF32
                off, the gap with TF32 on recorded; times of the epochs and
                20 train steps, and their profile.
  17. train_dp — (run after train) the mesh's data axis: DP_RANKS ranks
                share the one card over gloo (NCCL takes one rank a
                device).  Ranks spawned by ``torch.multiprocessing`` join
                through ``parallel.maybe_initialize_distributed`` with
                torchrun's variables: ``gather_dual_sharded`` launches B1
                once a call, the shard taken in the kernel, and both ranks' rows are bit-equal to one
                process's ``gather_dual_fast`` and to the plain
                ``gather_dual`` (f32 and bf16 scenes; B 4096 with corner
                anchors, B 4160, B 1025, the train batch 256, anchors past
                the scene); the wrapper timed on each rank in turn at B 4096 and
                4160 beside the plain route, one indexing call a stream on
                the shard and the shard's bytes bound; three f32 SGD steps
                (TF32 off) of gmfnet w64 from seeded weights, a padded
                batch first and two full ones of 256, through the two ranks
                and through one process: losses within DP_LOSS_ATOL,
                parameters within DP_PARAM_ATOL, and a mean of the ranks'
                own means (DDP's rule) outside them; 20 timed steps a
                rank (B1 once a step, counted) and a profile of 5 on rank
                0 (the all-reduce's share); the kernels line counts both
                ranks' launches in their steps.  The CLI on the data axis
                runs in train_dp_streams (tri_net, the two-stage solver),
                train_dp_maps (dense_fusion, and gmfnet_conv through the
                same per-anchor programs and sharded gather as gmfnet's)
                and train_tp (gmfnet on the model axis).
  18. train_dp_streams — (run after train_dp) the tri and quad arities
                and stage 1 on the data axis, DP_RANKS ranks sharing the
                card over gloo.  Spawned ranks build the same MSPAN (by
                digest); ``gather_tri_fast`` and ``gather_quad_fast`` on
                the rank's shard launch B1 once a call, and both
                ranks' rows are bit-equal to the plain ``gather_tri`` and
                ``gather_quad`` (f32 and bf16 scenes; B 4096 with corner
                anchors, B 4160, B 1025, B 256, anchors past the scene),
                each timed at B 4096 on each rank in turn beside the plain
                route, one indexing call a stream and the shard's bytes
                bound; three f32 SGD steps (TF32 off) of dqtl w64, the
                padded batch first, through the two ranks (qua_loss on the
                whole batch's logits) and one process: losses within
                DPS_QUAD_LOSS_ATOL, parameters within DPS_QUAD_PARAM_ATOL,
                each rank's qua_loss on its own shard outside them; then an
                eval batch of 4096 through both (loss sum, five
                confusions, fused prediction); three f32 GAN steps at
                gan_width 32 on 64x64 crops, two tiles a rank, against one
                process fed the same noise (losses within
                DPS_GAN_LOSS_RTOL, Adam's moments within
                DPS_GAN_MOMENT_RTOL of their largest, parameters within
                Adam's step bound),
                summed gradients outside the moments' limit; tri, quad and
                GAN steps timed a rank, with profiles of the all-reduce's
                and all-gather's shares on rank 0.  Then two runs, at once
                (their start-ups overlap), of
                ``python -m torch.distributed.run --standalone
                --nproc-per-node 2 -m dmfusion_torch.cli ...
                mesh.distributed=1``: tri_net (the train phase's set, one
                epoch, no test, color over the unlabeled pixels) and
                ``--solver twostage`` with ``dqtl.pre_trained=0`` (the
                config's stage-1 widths, DPS_GAN_EPOCHS GAN epoch,
                DPS_STAGE2_EPOCHS stage-2 epoch, no test: train_gan tests
                dqtl on stage 1's scenes): one result tree each, the GAN
                scenes and files of the weights dir, finite records, tri's
                val OA at least 0.5, each rank's B1 launches once a gathered batch (tri and
                quad), counted from the split.
  19. train_dp_maps — (run after train_dp_streams) the dense family and
                gmfnet_conv on the data axis, DP_RANKS ranks sharing the
                card over gloo.  Spawned ranks: two f32 SGD steps (TF32
                off) of dense_fusion w32 on train_dense's 200x200 crop, each
                rank computing its band of ``band_plan(215, 2)``, against
                one process: losses within DPM_LOSS_RTOL, parameters within
                DPM_PARAM_RTOL and DPM_PARAM_ATOL, and the window sums added
                through ``torch.distributed.nn`` (twice the gradient)
                outside them; the image6 map of seeded w32 weights from
                every rank's band against one process's whole map: f32
                logits within DPM_LOGITS_ATOL and argmax agreement at least
                DPM_AGREE_F32, the bf16 class map at least DPM_AGREE_BF16,
                B2 once a map on each rank; a band's map and the whole map
                timed on each rank in turn; dense steps (bf16, batch 256)
                timed a rank, a profile on rank 0 (the all-reduces' share,
                the top device ops), and the window-sum and gradient
                all-reduces timed alone.  Then two runs, at once, of
                ``python -m
                torch.distributed.run --standalone --nproc-per-node 2 -m
                dmfusion_torch.cli ... mesh.distributed=1``: dense_fusion
                (train_dense's set, one epoch, test and color) and
                gmfnet_conv (train_conv's set, one epoch, val per anchor,
                no test and no color): one result tree each, finite
                records, val OA at least 0.5, the dense run's test matrix
                of the test split with OA at least 0.5, each
                rank's band as ``band_plan`` gives it, and each rank's B2
                launches (one a map: val, test, color) and B1 launches
                (once a gathered batch), counted from the split.
  20. train_tp — (run after train_dp_maps) the mesh's model axis:
                TP_RANKS spawned ranks form a data 2 x model 2 mesh sharing
                the card over gloo (rank r: data index r // 2, model index
                r % 2), parameters and SGD/Adam moments sharded by
                ``parallel/partition.py``.  Three f32 SGD steps (TF32 off)
                from seeded weights, the padded batch first, through the
                mesh and through one process (the one-process runs spread
                over the ranks, broadcast): gmfnet w64 at patch 16 on
                image6 (batch 256), vit at the config's embed 96, depth 2
                with ``trans.num_head=4`` (its heads shard; batch
                TP_VIT_BATCH), two steps of dense_fusion w32 on
                train_dense's crop (its band of ``band_plan(215, 2)`` a
                data index, B2 once a rank on the band map after them, the
                map against one process's: argmax agreement at least
                DPM_AGREE_F32), and TP_FAMILIES at the config's widths
                (tri_net, gmfnet_conv at patch 47, swin_transformer,
                ct_lstm, dqtl replicated; resnet18, cross_net, swin_T_dual
                and the single arity one step each): losses within
                TP_LOSS_RTOL, parameters within TP_PARAM_RTOL and
                TP_PARAM_ATOL; gmfnet's, tri_net's and dqtl's gradients
                summed over every rank, and rank 0's gmfnet shards
                broadcast over every rank, outside them; dqtl's model peers
                bit-equal after its steps; three GAN steps at gan_width 32,
                replicated, the same noise on every rank, within the data
                axis's GAN limits (DPS_GAN_LOSS_RTOL, DPS_GAN_MOMENT_RTOL,
                Adam's step bound), summed gradients outside them, the
                model peers bit-equal; B1 on the data shard
                (``gather_dual_sharded``, ``gather_tri_fast``,
                ``gather_quad_fast``: one launch a call) at B 4096 and B
                256 bit-equal to the plain gathers and to the model peer's
                rows; every sharded parameter and Adam moment of gmfnet,
                vit, dense_fusion and the sharded TP_FAMILIES of the
                shard's shape, the bytes a rank holds beside one
                process's; TP_STEPS timed bf16 Adam steps a rank of gmfnet
                (B1 once a step) and of tri_net (once), counted, and a
                profile of 5 on rank 0 (the all-gathers' and all-reduces'
                share), timed alone after the CLI runs.  Meanwhile (the
                start-ups overlap) two runs of ``python -m
                torch.distributed.run --standalone --nproc-per-node 2 -m
                dmfusion_torch.cli ... mesh.distributed=1 mesh.model=2``
                (data 1 x model 2) go at once: ``--set <TRAIN_SET> epoch=1
                test.index=0 train_rate=0.002 verify_rate=0.002`` (gmfnet
                w64, 23 steps): one result tree, finite records, each
                rank's report (``mesh_model`` 2) with B1 launched once per
                gathered batch (train and val), counted from the split; the
                best weights loaded in one process on the card give the
                run's val OA within TP_VAL_OA_ATOL and val loss within
                TP_VAL_LOSS_RTOL (bf16: the sharded layers add their bias
                after the gather); and TP_TWOSTAGE_SET (``--solver
                twostage``, dqtl replicated: one GAN epoch, 23 stage-2
                steps): one result tree and weights dir, the GAN scenes
                finite in [0, 1], finite records, B1 once a gathered
                batch on each rank.  The kernels line counts the ranks'
                step launches and both CLI runs' (B1) and the band maps'
                (B2).
  21. diagnostics — (run after train_gan, on the solvers that train and
                train_gan trained and kept) ``visualize()`` of the gmfnet
                solver: its t-SNE of TSNE_POINTS test anchors' logits on
                the card, ``{time}_tsne_test.png`` written with the
                scatter's IHDR shape; the same logits through
                ``report/tsne.py`` on the card (timed) and in float64 on
                the CPU (in a thread, beside the work below): joint
                probabilities within TSNE_P_RTOL, final KL within
                TSNE_KL_SHARE; ``visualize()`` of the two-stage solver (the
                four streams' logits of 500 train anchors,
                ``{time}_tsne_streams.png``); one epoch of the gmfnet
                solver's train ids at batch 256 through ``H5DualPrograms``
                on ``gather_patches``' rows and through ``DualPrograms`` on
                the scene from the same weights, cuDNN deterministic:
                losses within H5_LOSS_ATOL; B1 launched 1 + 1 + 1 + 1 a
                batch on this path.  Then the single arity, as its own
                path: ``SingleNet`` (registered with a module ``ARITY =
                "single"``, w64, patch 16, image6) trained for one epoch
                by the CLI (``SINGLE_SET``), tested on SINGLE_BUCKETS
                buckets of 4096 of its test split, exported and served
                (SINGLE_REQUESTS requests of 4096, equal to the solver's
                predictions): ``gather_one_fast`` launched once per batch
                (train, val, test, requests), more than 0, and bit-equal to
                ``gather_one`` on that scene at B 256 and 4096, where it is
                timed at both.  Last,
                ``collect`` over the five CLI runs' result workbooks
                (train, train_dense, train_conv, train_gan, single): two
                rows each.
  22. norm    — (run after serving) the fused GroupNorm + residual +
                activation (B5) at each of gmfnet-w64-p16's 13 norms at B
                4096, channels-last bf16, against its plain version: at
                least 99 % of elements bit-equal, none more than 2 ulps
                apart (``tools/norm_probe.run``); the kernel, the plain
                version and the library path it replaces (``F.group_norm``
                under autocast, the add, ReLU) timed at each, with the
                bytes bound; the unit row is ms_res's second norm, and the
                13 launches of a request are summed.
  23. attn    — (run after norm) the fused window-attention core (B6) at
                each of Swin-T's four stage shapes at B 1024 (window 7,
                hd 32), unshifted and shifted under its mask, bf16,
                against its plain version on the card (largest gap,
                absolute and relative) and, over all 1,024 anchors and
                over the first 16 alone, both against a float64 truth:
                the kernel's mean error at most the plain version's, its
                largest at most twice it; the float32 body
                within 1e-5 of the plain version (TF32 off); the kernel,
                the plain version and ``F.scaled_dot_product_attention``
                on the partitioned q, k and v (a yardstick) timed at each,
                with the bytes bound, and the 24 calls of a request summed
                (``tools/attn_probe.run``); then ``swin_t_dual`` at
                Swin-T's widths, patch 56, served in requests of 1,024
                through ``ScenePredictor``: 24 B6 launches a request, 12
                masked, none bypassed, and the device time
                ``key_averages()`` gives the ``swin.attn`` spans of a
                profiled request within 5 % of B6's own CUDA-event time
                (``tools/attn_probe.serve``); the unit row is the first
                stage's shifted core.
Every phase logs its seconds (``phase NAME: S s``), and a ``phase
seconds`` line sums them up.  Then a ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  The
kernels build in parallel, one ``nvcc`` per source.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from dmfusion_torch import parallel
from dmfusion_torch.config import load_config, resolve_device
from dmfusion_torch.data.patches import (batched_ids, batched_ids_np,
                                         gather_dual, gather_one, gather_quad,
                                         gather_tri)
from dmfusion_torch.data.scene import (mspan_scene, quad_streams, split_labels,
                                       synthetic_scene)
from dmfusion_torch.export import load_artifact, save_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.models import build_model
from dmfusion_torch.models import dense_fusion
from dmfusion_torch.models.common import (ConvBlock, MLPHead, ResBlock,
                                          activation_fn, dtypes, init_params,
                                          tree_shape)
from dmfusion_torch.models.registry import register
from dmfusion_torch.ops import gather as gather_ops
from dmfusion_torch.ops import ihs
from dmfusion_torch.ops import norm as norm_ops
from dmfusion_torch.ops import attention as attn_ops
from dmfusion_torch.ops import conv3x3 as conv_ops
from dmfusion_torch.ops import pool as pool_ops
from dmfusion_torch.ops import strip_gather as strip_ops
from dmfusion_torch.ops._build import load_library
from dmfusion_torch.ops.metrics import aa_oa, confusion_matrix, render_class_map
from dmfusion_torch.tools import (BF16_FLOP_PER_S, HBM_BYTES_PER_S, card_line,
                                  attn_probe, conv_kernel_probe,
                                  gather_probe, norm_probe, ptxas_report,
                                  strip_gather_bench, time_in_turns)
from dmfusion_torch.parallel.mesh import all_gather_rows
from dmfusion_torch.parallel.partition import full_state, shard_model
from dmfusion_torch.parallel.tensor import shard_dims
from dmfusion_torch.train import steps as steps_mod
from dmfusion_torch.train.gan import GanPrograms
from dmfusion_torch.train.steps import (DensePrograms, DualPrograms,
                                        QuadPrograms, SinglePrograms,
                                        TriPrograms)

BUCKET = 4096
REQUESTS = 32
WARMUP = 3
# bf16 card logits vs f32 CPU logits: on the CPU, bf16 gmfnet at width 64
# lands 0.009-0.011 (max abs over 64 anchors) from its f32 logits, for
# dmfusion and for this port alike; a skipped or wrong layer moves them by
# the logits' own scale (about 1).
BF16_ATOL = 0.04
CFG = {"data_city": "image6", "patch_size": 16, "seed": 3407,
       "model_width": 64, "device": "cuda",
       "precision": {"compute_dtype": "bfloat16", "scene_dtype": "float32"}}
# The dense flagship: image6, width 32 (128 trunk channels), patch 16.
DENSE_CFG = {**CFG, "model_name": "dense_fusion", "model_width": 32}
DENSE_WARMUP, DENSE_MAPS, DENSE_BANDS = 2, 10, 4
# bf16 card logits vs f32 CPU logits of the dense model on a 96x96 crop:
# on the CPU the port's bf16 lands 0.00046-0.00059 (max abs over the
# 81x81x12 logits of four crops) from its f32 logits, at a logit scale of
# 0.024-0.029 for these seeded weights; a skipped or wrong layer moves
# them by that scale.
DENSE_BF16_ATOL = 0.002
# The strip bench's workload: 98,304 raster anchors in strips of 128.
STRIP_ANCHORS, STRIP = 98_304, 128
# The conv's checks off the probe's shape: odd shapes, then shapes on and
# off the kernel's 8 x 32 output tile.
CONV_SHAPES = ((37, 45), (5, 70), (1, 1), (9, 33), (8, 32), (7, 31),
               (1, 100), (100, 1))
# The train phase: the default run (gmfnet w64, patch 16, batch 256, Adam,
# bf16 compute, f32 scene) on image6 through the CLI, two epochs and test;
# eval batches are 4096 anchors on the card.  No per-anchor run on one
# rank colors: a color pass is a per-anchor pass as long as the test, and
# its route (``Solver._predict_ids``) is held by the served requests of
# train_tri, train_quad and train_gan; train_dp_streams' tri run colors
# per anchor under the mesh, and the map runs color by their maps.
TRAIN_SET = ["data_city=image6", "epoch=2", "time=1", "color.index=0",
             "nohup=1"]
TRAIN_BATCH, EVAL_BATCH, PARITY_STEPS, PROFILE_STEPS = 256, 4096, 3, 20
HOST_STEPS = 5
# bf16 vs f32 per-step training losses on the card, three Adam steps from
# the same seeded w64 weights (gmfnet, and tri_net: 0.0041 apart on the
# CPU); a wrong layer or a lost update moves the loss (about 2.4 for 12
# classes at init) by far more.
TRAIN_BF16_ATOL = 0.05
# The dense training run: the tentpole command line, on image6.
DENSE_TRAIN_SET = ["model_name=dense_fusion", "model_width=32",
                   "data_city=image6", "epoch=2", "time=1", "color.index=1"]
DENSE_CROP, DENSE_PROFILE_STEPS = 200, 5
# bf16 vs f32 per-step dense training losses, three Adam steps on the crop
# from the same seeded w32 weights; a wrong layer or a lost update moves
# the loss (about 2.5 for 12 classes at init) by far more.
DENSE_TRAIN_BF16_ATOL = 0.05
# bf16 vs f32 argmax agreement on the trained image6 map: the reference
# flips 0.4-0.5 % of near-tie argmaxes between the two (BENCH_NOTES.md).
DENSE_AGREE_MIN = 0.99
# The conv-map training run: the tentpole command line (gmfnet_conv w64,
# patch 47, batch 256, bf16, f32 image6 scene), then its export with --map.
CONV_TRAIN_SET = ["model_name=gmfnet_conv", "patch_size=47",
                  "data_city=image6", "epoch=2", "time=1", "color.index=1"]
CONV_CFG = {**CFG, "model_name": "gmfnet_conv", "patch_size": 47}
# The f32 route parity crop (anchors a side), and the A/B's anchors: the
# per-anchor route's sample and its first 32,768 for the bf16 agreement
# (the reference flips 0.4-0.5 % of near-tie argmaxes between bf16 and
# f32, BENCH_NOTES.md; the two routes differ in bf16 by their summation
# order).
CONV_CROP, CONV_AB_ANCHORS, CONV_AB_PARITY = 200, 98_304, 32_768
CONV_AGREE_MIN = 0.99
# A bf16 map in 3 bands against the whole one, as the dense phase holds its
# 4 bands (near-tie flips where cuDNN's kernels differ by shape).
CONV_BAND_AGREE_MIN = 0.999
# The tri training run: the tentpole command line (tri_net w64, patch 16,
# batch 256, bf16, f32 image6 scene), without test (train_dp_streams' tri
# run tests tri_net, OA at least 0.5); then its export, served by 8
# requests of 4096 labeled anchors.
TRI_TRAIN_SET = ["model_name=tri_net", *TRAIN_SET, "test.index=0"]
TRI_REQUESTS = 8
# The two-stage run: stage 2 of the DQTL solver, the tentpole command line
# (dqtl w64, patch 16, batch 256, bf16, four f32 image6 streams) on seeded
# stage-1 scenes, without test (train_gan tests dqtl on stage 1's own
# scenes: the fused and MS OA at least 0.5, the stream matrices, the
# streams sheet); then its export, served by 8 requests of 4096 labeled
# anchors with the GAN scenes, equal to the solver's per-anchor
# prediction (its color route).
QUAD_TRAIN_SET = ["--solver", "twostage", "--set", "model_name=dqtl",
                  "dqtl.pre_trained=1", *TRAIN_SET, "test.index=0"]
QUAD_REQUESTS = 8
# The seeded stage-1 scenes: msgan (the GAN's fake PAN) is pan2ms(PAN) and
# pangan (its fake MS) is MS, each plus seeded normal noise of this scale
# (the synthetic scene's own noise is 0.25).
GAN_NOISE = 0.1
# bf16 vs f32 per-step qua_loss, three Adam steps from the same seeded w64
# dqtl weights: on the CPU 1.1e-4-3.0e-4 apart on two image6 draws, at a
# loss of 0.09-0.11 (a KL, far smaller than a 12-class cross-entropy); a
# wrong layer or a lost update moves the loss by a good part of its size.
QUAD_TRAIN_BF16_ATOL = 0.003
# The stage-1 run: the two-stage solver with dqtl.pre_trained 0 at the
# config's stage-1 widths (gan_width 32, pic 128, batch 4: 272 image6
# tiles, 68 steps an epoch), cut to 3 epochs (the config's 10 cost 7 s
# each: the first keeps its sample grids, the second none, the last every
# fake), then stage 2 (dqtl w64, patch 16, batch 256, bf16) for two epochs
# and its test; color is off.
GAN_WIDTH, GAN_PIC, GAN_BATCH, GAN_EPOCHS, GAN_STEPS = 32, 128, 4, 3, 68
GAN_TRAIN_SET = ["--solver", "twostage", "--set", "model_name=dqtl",
                 "dqtl.pre_trained=0", "dqtl.save_model=1",
                 f"dqtl.epochs={GAN_EPOCHS}", "data_city=image6",
                 "epoch=2", "time=1", "color.index=0", "nohup=1"]
GAN_PROFILE_STEPS, GAN_REQUESTS = 20, 2
# The GAN steps' card-vs-CPU parity: full width on tiles cropped to 64,
# two a step.  bf16 vs f32 losses, relative: on the CPU 0.0025-0.0038 apart
# at gan_width 32 (synth64 tiles, seeds 3407 and 1); the d loss (about 2-4)
# and the g loss (about 11, mostly L1 terms times 10) move by their own
# size under a wrong layer or a lost update.
GAN_PARITY_PIC, GAN_PARITY_BATCH = 64, 2
GAN_BF16_RTOL = 0.02
# The zoo: the config's baselines at its widths (resnet18's base 32; the
# transformers take ``trans``: embed 96, depth 2, 3 heads, patch 1; the
# Swin models its ``window_size`` 2, ``depths`` [2, 4], ``num_heads`` [3,
# 3]; ct_lstm ``model_width`` 64).
ZOO = {"resnet18": {"model_width": 32}, "cross_net": {},
       "vision_transformer": {}, "swin_transformer": {}, "swin_T_dual": {},
       "ct_lstm": {"model_width": 64}}
ZOO_STEPS, ZOO_REQUESTS = 20, 8
# bf16 vs f32 logits of the zoo after 20 Adam steps, on the CPU over 256
# image6 anchors: 0.0116 (resnet18), 0.0377 (cross_net), 0.0283 (vit),
# 0.0077 (swin_transformer), 0.0177 (swin_T_dual), 0.0081 (ct_lstm), at
# logit scales of 1.4-4.7; at init 0.0028-0.037.  A skipped or wrong layer
# moves them by the logits' own scale.
ZOO_BF16_ATOL = 0.12
# bf16 vs f32 argmax agreement over a request: the reference flips 0.4-0.5
# % of near-tie argmaxes between the two (BENCH_NOTES.md).  After 20 steps
# swin_transformer still predicts the class prior (its loss is ln 11, as
# dmfusion's from the same start: 1.3e-4 apart over the 20 f32 steps on
# the CPU): its logits part by about 0.002 between anchors, its top two
# classes by a median of 0.004, under its bf16 gap, so bf16 flips ties
# (0.79 agreement over 256 anchors on the CPU, 1.0 over 4096 on the H100);
# its floor is half, the share of a coin flip between the two.
ZOO_AGREE_MIN = 0.99
ZOO_AGREE_MIN_BY = {"swin_transformer": 0.5}
# The contourlet training run: ``python -m dmfusion_torch.cli --set
# model_name=ct_lstm epoch=2 time=1 color.index=0 proof.index=1`` on image6
# (w64, patch 16, batch 256, bf16, f32 scene): train, val and the four
# proof grids, without test (a per-anchor pass of 2,826,002 anchors).  Its
# last val OA, over the 58,875 held-out val anchors, is held to 0.5, as
# every training cell's accuracy: on the card it tests at 0.964 after 2
# epochs (on the CPU drive, synth64 at patch 8 and width 8, only 0.25,
# the majority class).
CT_TRAIN_SET = ["model_name=ct_lstm", "data_city=image6", "epoch=2",
                "time=1", "color.index=0", "test.index=0", "proof.index=1",
                "nohup=1"]
CT_OA_MIN = 0.5
# The data axis on the card: DP_RANKS ranks share the one H100 over gloo
# (NCCL takes one rank a device).  The sharded gather at a bucket, at
# unequal shards, at the count where dmfusion's shard padding fails and
# at the train batch (128 rows a rank on every train step).
DP_RANKS = 2
DP_GATHER_B = (4096, 4160, 1025, 256)
# Three SGD steps in f32 (TF32 off), two ranks against one process: the
# two differ only in the order of the sums (a rank's partial sums, then
# the all-reduce of the gradients).  Measured with the padded batch last:
# parameters 3e-8 to 2.4e-7 apart (H100 80GB HBM3, 700.00 W).
DP_LOSS_ATOL, DP_PARAM_ATOL = 1e-5, 1e-6
DP_PROFILE_STEPS = 5
DP_TIMEOUT = 400
# The tri and quad arities and stage 1 on the data axis (phase
# train_dp_streams), DP_RANKS ranks sharing the card over gloo as in
# train_dp.  Three f32 SGD steps of dqtl w64 (TF32 off), two ranks against
# one process, the padded batch first: the losses and parameters differ
# only in the order of the sums (readings 7.5e-9 to 1.5e-8, H100 80GB
# HBM3, 700.00 W; the limits are the dual path's).
DPS_QUAD_LOSS_ATOL, DPS_QUAD_PARAM_ATOL = 1e-5, 1e-6
# Three GAN steps at gan_width 32 on 64x64 crops, batch 4 (two tiles a
# rank), f32 (TF32 off), two ranks against one process fed the same noise.
# The losses are held to dmfusion's own rtol for its mesh
# (tests/test_gan.py); Adam's moments to DPS_GAN_MOMENT_RTOL of their
# largest: an L1 term's sign flips on a rounding-level difference and
# moves the gradient by about 1e-4 of its size (on the CPU), and cuDNN's
# f32 sums vary from run to run (the moments at most 1e-4 apart in one
# run and 2.2e-4 in the next, H100 80GB HBM3, 700.00 W); the parameters
# to Adam's step bound, both sides, where a gradient is rounding noise (a
# step moves an element by about lr, by up to 2 lr early on: 4 lr a
# step).  Summing the ranks' gradients instead doubles the first moment:
# as far apart as its size.
DPS_GAN_LOSS_RTOL, DPS_GAN_MOMENT_RTOL = 1e-4, 1e-2
# Timed steps a rank (after 3) and profiled steps on rank 0: tri and quad
# at batch 256, the GAN at pic 128 and batch 4.
DPS_STEPS, DPS_PROFILE_STEPS, DPS_GAN_STEPS = 20, 5, 10
# The CLI under torchrun: tri_net as the train phase's run, cut to one
# epoch, without test (its val OA, over 58,875 held-out anchors through the
# same eval under the mesh, is held to 0.5; train_dp_maps' dense run tests
# under the mesh), with color over the
# unlabeled pixels (the mesh's predict on the card);
# then the two-stage solver with dqtl.pre_trained 0 at the config's stage-1
# widths, cut to one GAN epoch (it keeps its sample grids and every fake)
# and one stage-2 epoch, without test (train_gan tests dqtl on stage 1's
# scenes) and color.
DPS_GAN_EPOCHS, DPS_STAGE2_EPOCHS = 1, 1
DPS_TRI_SET = ["--set", "model_name=tri_net", *TRAIN_SET, "epoch=1",
               "test.index=0", "color.index=1", "color.supervised=0",
               "color.unsupervised=1"]
DPS_TWOSTAGE_SET = ["--solver", "twostage", "--set", "model_name=dqtl",
                    "dqtl.pre_trained=0", "dqtl.save_model=1",
                    f"dqtl.epochs={DPS_GAN_EPOCHS}", "data_city=image6",
                    f"epoch={DPS_STAGE2_EPOCHS}", "time=1", "color.index=0",
                    "test.index=0", "nohup=1"]
DPS_TIMEOUT = 600
# The dense family and gmfnet_conv on the data axis (phase train_dp_maps),
# DP_RANKS ranks sharing the card over gloo as in train_dp.  Two f32 SGD
# steps of dense_fusion w32 (TF32 off) on train_dense's 200 x 200 crop,
# which bands on two ranks, against one process: dmfusion's limits for its
# mesh (tests/test_dense.py), losses rtol 1e-5 and parameters rtol 1e-4
# atol 1e-7.  The two differ in the order of the sums (the bands' SATs, the
# features' gradients summed over the ranks).
DPM_LOSS_RTOL, DPM_PARAM_RTOL, DPM_PARAM_ATOL = 1e-5, 1e-4, 1e-7
# The band map of seeded w32 weights on two ranks against one process's
# whole map: f32 logits (TF32 off) within 1e-4 and argmax agreement at least
# 0.9995 (dmfusion's own for its mesh); bf16 argmax agreement at least 0.999,
# as the dense phase holds its 4 bands (near-tie flips where cuDNN's
# kernels differ by shape).
DPM_LOGITS_ATOL, DPM_AGREE_F32, DPM_AGREE_BF16 = 1e-4, 0.9995, 0.999
# Timed dense steps a rank (after 3) at batch 256, bf16, the whole image6
# scene, and timed collectives (the window sums' and the gradients').
DPM_STEPS, DPM_COLLECTIVES = 20, 20
# The CLI under torchrun: dense_fusion as train_dense's run, one epoch, with
# test and color (both render the class map: B2 on every rank's band), and
# gmfnet_conv as train_conv's, one epoch, without test and color: its val
# pass is the per-anchor eval under the mesh (val OA at least 0.5), the
# dense run tests under the mesh, and train_dp_streams' tri run colors per
# anchor under the mesh (its per-anchor test pass of 2,826,002 anchors
# took 33 s on "NVIDIA H100 80GB HBM3, 700.00 W").
DPM_DENSE_SET = ["--set", *DENSE_TRAIN_SET, "epoch=1", "nohup=1"]
DPM_CONV_SET = ["--set", *CONV_TRAIN_SET, "epoch=1", "color.index=0",
                "test.index=0", "nohup=1"]
DPM_TIMEOUT = 600
# The mesh's model axis on the card (phase train_tp): TP_RANKS spawned ranks
# form a data 2 x model 2 mesh sharing the one H100 over gloo.  Three f32
# SGD steps (TF32 off) against one process from the same seeded weights,
# the padded batch first, held to dmfusion's own limits for its TP mesh
# (tests/test_parallel.py): losses rtol 1e-5, parameters rtol 1e-4 atol
# 1e-6.  The two differ in the order of the sums (the peers' input
# gradients added, cuDNN's algorithms at the shards' shapes).
TP_RANKS, TP_MODEL = 4, 2
TP_LOSS_RTOL, TP_PARAM_RTOL, TP_PARAM_ATOL = 1e-5, 1e-4, 1e-6
# vit at the config's trans (embed 96, depth 2, patch 1: 513 tokens) with 4
# heads, so that they shard on two model ranks; batches of 64 (the padded
# one 40 real), as the attention's (B, heads, 513, 513) f32 scores of one
# process and four ranks share the card.
TP_VIT = {"model_name": "vision_transformer", "trans": {"num_head": 4}}
TP_VIT_BATCH, TP_VIT_REAL = 64, 40
# gmfnet's padded batch: 200 real rows of 256 (100 on each data index).
TP_REAL = 200
# Timed TP steps a rank (after 3, gmfnet w64, Adam, bf16, batch 256), then
# a profile of DP_PROFILE_STEPS on rank 0.
TP_STEPS = 10
# The CLI under torchrun on two ranks, data 1 x model 2: the train phase's
# run cut to one epoch, no test, and a tenth of its train and val anchors
# (23 steps of 256 and 2 val buckets of 4096: a model-axis step of gmfnet
# w64 took 0.40 s on the two ranks, 230 of them 98 s, "NVIDIA H100 80GB
# HBM3, 700.00 W"); its val pass is the per-anchor eval on the model axis,
# its OA recorded (no floor after 23 steps).  Its best weights, loaded in
# one process on the card, give the run's val confusion again up to bf16
# rounding: a sharded layer adds its bias after the gather, in bf16, where
# one process's cuDNN conv fuses it.  So near-tie argmaxes part, and after
# 23 steps the logits are near-uniform: OA 1.2e-3 apart (10 of 8,192
# anchors) and the loss sums 2.2e-5; after 230 steps 1.7e-5 and 8.4e-4.
TP_CLI_RANKS = 2
TP_CLI_SET = [*TRAIN_SET, "epoch=1", "test.index=0", "train_rate=0.002",
              "verify_rate=0.002"]
TP_VAL_OA_ATOL, TP_VAL_LOSS_RTOL = 5e-3, 1e-2
# The CLI run goes on while the spawned ranks hold their parity (their
# start-ups overlap); this file, written when it ends, lets the ranks time
# their steps alone.
TP_CLI_DONE = "cli_done"
TP_TIMEOUT = 600
# The diagnostics phase.  visualize's t-SNE of the trained gmfnet's
# ``visualize.samples`` (2,000) test logits, on the card and, in float64 on
# the CPU, by the same function: the joint probabilities relative to the
# CPU's within TSNE_P_RTOL (the same float64 arithmetic in another order;
# the card read 9.3e-16 on "NVIDIA H100 80GB HBM3, 700.00 W"), the final KL
# divergence within TSNE_KL_SHARE of the CPU's (1000 iterations amplify
# rounding: the card read 0.32 % there, and on the CPU two summation
# orders ended 0.7 % apart on 200 points).
TSNE_POINTS, TSNE_P_RTOL, TSNE_KL_SHARE = 2000, 1e-10, 0.02
# The patch cache: one epoch of the trained gmfnet's train ids in batches
# of 256 through H5DualPrograms (rows of the pre-gathered windows) and
# through DualPrograms (the scene, B1), from the same weights, cuDNN
# deterministic: the same inputs and kernels give the same losses, so the
# limit is float32 rounding of a loss of about 0.1.
H5_LOSS_ATOL = 1e-5
# The single arity at gmfnet's width (w64, patch 16, image6): a registered
# MS-only classifier (``SingleNet``) trained for one epoch on 0.2 % of the
# labeled pixels (5,887 anchors: 23 steps of 256) with its val pass (2
# buckets of 4096), tested on the first SINGLE_BUCKETS buckets of 4096 of
# its test split, exported and served in SINGLE_REQUESTS requests of 4096,
# each of those batches one gather_one_fast launch.
SINGLE_NAME = "single_ms"
SINGLE_SET = [f"model_name={SINGLE_NAME}", "data_city=image6", "epoch=1",
              "time=1", "train_rate=0.002", "verify_rate=0.002",
              "test.index=0", "color.index=0", "nohup=1"]
SINGLE_BUCKETS, SINGLE_REQUESTS = 16, 4
# The rest of the zoo on the model axis (phase train_tp), at the config's
# widths: name -> (its programs' kind, its config, its controls).  Three
# f32 SGD steps each against one process, the padded batch (TP_REAL of
# 256) first, at the TP limits: tri_net w64 (the gradients summed over
# every rank must miss), gmfnet_conv at patch 47, swin_transformer,
# ct_lstm (the contourlet on the card) and dqtl with its parameters
# replicated, as the two-stage solver keeps them (the world-group sum
# must miss; the model peers end bit-equal); TP_ONE_STEP take one step.
TP_FAMILIES = {
    "tri_net": ("tri", {"model_name": "tri_net"}, ("world_sum",)),
    "gmfnet_conv": ("conv", {"model_name": "gmfnet_conv",
                             "patch_size": 47}, ()),
    "swin_transformer": ("dual", {"model_name": "swin_transformer"}, ()),
    "ct_lstm": ("dual", {"model_name": "ct_lstm"}, ()),
    "dqtl": ("quad", {"model_name": "dqtl"}, ("world_sum",)),
    "resnet18": ("dual", {"model_name": "resnet18", "model_width": 32}, ()),
    "cross_net": ("dual", {"model_name": "cross_net"}, ()),
    "swin_T_dual": ("dual", {"model_name": "swin_T_dual"}, ()),
    SINGLE_NAME: ("single", {"model_name": SINGLE_NAME}, ())}
TP_ONE_STEP = ("resnet18", "cross_net", "swin_T_dual", SINGLE_NAME)
# The two-stage solver under torchrun on two ranks, data 1 x model 2, its
# parameters replicated: train_dp_streams' run (one GAN epoch over the 272
# image6 tiles, one stage-2 epoch, no test, no color) cut as the gmfnet
# TP run is, to a tenth of its train and val anchors (23 steps of 256 and
# 2 val buckets of 4096); B1 once a gathered batch on each rank.
TP_TWOSTAGE_SET = ["--solver", "twostage", "--set", "model_name=dqtl",
                   "dqtl.pre_trained=0", "dqtl.save_model=1",
                   f"dqtl.epochs={DPS_GAN_EPOCHS}", "data_city=image6",
                   f"epoch={DPS_STAGE2_EPOCHS}", "time=1", "color.index=0",
                   "test.index=0", "train_rate=0.002", "verify_rate=0.002",
                   "nohup=1"]
ROOT = os.path.dirname(os.path.abspath(__file__))
# One entry per CUDA source of the driven paths.
KERNELS = {
    "gather_windows": {
        "route": "cuda", "source": "dmfusion_torch/csrc/gather_windows.cu",
        "replaces": "dmfusion/ops/pallas_gather.py:90",
        "counter": gather_ops.gather_windows_cuda,
        "unit": f"one dual bucket: MS and PAN in one launch, B={BUCKET}, "
                f"f32 scene"},
    "phase_pool": {
        "route": "cuda", "source": "dmfusion_torch/csrc/phase_pool.cu",
        "replaces": "dmfusion/ops/pallas_pool.py:124",
        "counter": pool_ops.phase_pool_cuda,
        "unit": "one image6 w32 map pool: (1008, 1058, 128) -> "
                "(1001, 1051, 128) bf16, patch 16"},
    "strip_gather": {
        "route": "cuda", "source": "dmfusion_torch/csrc/strip_gather.cu",
        "replaces": "dmfusion/ops/pallas_strip_gather.py:80",
        "counter": strip_ops.gather_strips_cuda,
        "unit": f"one dual strip call: MS + PAN launch, {STRIP_ANCHORS} "
                f"image6 raster anchors in strips of {STRIP}, f32 scene"},
    "conv3x3": {
        "route": "cuda", "source": "dmfusion_torch/csrc/conv3x3.cu",
        "replaces": "tools/conv_kernel_probe.py:133",
        "counter": conv_ops.conv3x3_cuda,
        "unit": "one 3x3 128->128 SAME conv pass, (1008, 1058, 128) bf16"},
    "group_norm_act": {
        "route": "cuda", "source": "dmfusion_torch/csrc/group_norm_act.cu",
        "replaces": "none",
        "counter": norm_ops.group_norm_act_cuda,
        "unit": "ms_res's second norm: (4096, 64, 16, 16) bf16 "
                "channels-last with residual, ReLU"},
    "window_attn": {
        "route": "cuda", "source": "dmfusion_torch/csrc/window_attn.cu",
        "replaces": "none",
        "counter": attn_ops.window_attn_cuda,
        "unit": "Swin-T's first-stage shifted core: (1024, 56, 56, 288) "
                "bf16 qkv, window 7, 3 heads of 32, masked"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card only")
    card = card_line()
    device = resolve_device(load_config(overrides=CFG))
    log(f"device: {torch.cuda.get_device_name(device)} | nvidia-smi: {card} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    return device, card


def phase_build() -> None:
    """One nvcc per source, all started together, and one more for the
    window gather's registers and spills (``-Xptxas -v``)."""
    def build(name):
        t0 = time.perf_counter()
        load_library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as ex:
        ptxas = ex.submit(ptxas_report, "gather_windows")
        secs = dict(zip(KERNELS, ex.map(build, KERNELS)))
        log(f"build: gather_windows.cu ptxas: {json.dumps(ptxas.result())}")
    log(f"build: {json.dumps(secs)}, {time.perf_counter() - t0:.2f} s in all")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def time_gather(scene, streams: tuple, gathers: tuple, batch: int, rng,
                at_ms: int = 1, profile: bool = False) -> dict:
    """Time one family call of ``batch`` anchors over ``streams`` (the
    first ``at_ms`` at MS geometry: MS, or the quad's four; the rest at PAN
    geometry: PAN, MSPAN), f32 scenes, from the flat ids as the main path
    makes it: the kernel wrapper (one launch), the plain version
    (``gathers``: the (plain, kernel) pair, as ``DualPrograms.gathers``)
    and one indexing call a stream, in turns
    (``tools/gather_probe.time_call``); print them with the bytes bound and
    the wrapper's host time (and with ``profile`` the profiler's device
    time); return that row (ms)."""
    plain_gather, fast_gather = gathers
    scales = (1,) * at_ms + (4,) * (len(streams) - at_ms)
    row = gather_probe.time_call(streams, plain_gather, fast_gather, scales,
                                 scene.width, scene.patch, batch, rng)
    every = row.pop("all")
    row.pop("moved_bytes")
    tag = fast_gather.__name__.removesuffix("_fast")
    if profile:
        sets = [torch.from_numpy(rng.integers(0, scene.num_pixels, batch)
                                 .astype(np.int32)).to(streams[0].device)
                for _ in range(20)]
        prof = _profile(lambda: [fast_gather(*streams, ids, scene.width,
                                             scene.patch) for ids in sets],
                        f"20 {tag} calls, B {batch}", 3)
        row["device_ms"] = prof["gather_kernel_ms"] / len(sets)
        if not row["device_ms"]:
            log(f"kernels: the profiler saw no gather kernel: {prof}")
    log(f"kernels: {tag} B={batch} f32 ms median of 6: kernel "
        f"{row['ms']:.4f} (host {row['host_ms']:.4f}"
        + (f", device {row['device_ms']:.4f}" if profile else "")
        + f") plain {row['plain_ms']:.4f} library {row['library_ms']:.4f} "
        f"bound {row['bound_ms']:.4f}; all: {json.dumps(every)}")
    return row


def phase_kernels(scene, device, mspan, quad) -> dict:
    """Every family call of the window gather against its plain version at
    image6 shapes (``mspan``: the seeded IHS MSPAN scene; ``quad``: the
    two-stage solver's four streams), one launch a call
    (``tools/gather_probe.check_calls``), then the one-stream and dual
    calls timed."""
    ps, w = scene.patch, scene.width
    h, c = scene.height, int(scene.ms.shape[-1])
    ms2d = scene.ms.reshape(scene.ms.shape[0], -1)
    # image6 at patch 16: MS view (2016, 8464), PAN view (8067, 8467).
    check(tuple(ms2d.shape) == (h + ps - 1, (w + ps - 1) * c),
          f"MS view {tuple(ms2d.shape)}")
    check(tuple(scene.pan.shape) == (4 * h + 4 * ps - 1, 4 * w + 4 * ps - 1),
          f"PAN view {tuple(scene.pan.shape)}")
    try:
        worst = gather_probe.check_calls(
            {"ms": scene.ms, "pan": scene.pan, "mspan": mspan, "quad": quad},
            w, ps, device, lambda m: log(f"kernels: {m}"))
    except RuntimeError as e:
        check(False, f"kernels: {e}")
    rng = np.random.default_rng(0)
    one = time_gather(scene, (scene.ms,),
                      (gather_one, gather_ops.gather_one_fast), BUCKET, rng)
    dual = time_gather(scene, (scene.ms, scene.pan), DualPrograms.gathers,
                       BUCKET, rng, profile=True)
    # The quad bucket is timed here: in train_quad's phase the profiler
    # recorded no device activity of these calls (PERF.md, section 6).
    quad_rows = {f"B{b}": time_gather(scene, quad, QuadPrograms.gathers, b,
                                      rng, at_ms=4, profile=True)
                 for b in (BUCKET, TRAIN_BATCH)}
    return {"gather_windows": {"max_abs_err": worst, **dual,
                               "one": {"B4096": one}, "quad": quad_rows}}


def phase_serving(scene, device) -> dict:
    cfg = load_config(overrides=CFG)
    model = init_params(build_model(cfg),
                        torch.Generator().manual_seed(cfg["seed"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/gmfnet_image6.zip"
        save_artifact(path, cfg, model)
        clf = load_artifact(path, device)
    pred = ScenePredictor(clf, scene, bucket=BUCKET)
    labeled, _ = split_labels(scene.label)
    rng = np.random.default_rng(cfg["seed"])
    picked = rng.choice(labeled, (WARMUP + REQUESTS) * BUCKET, replace=False)
    chunks = picked.reshape(-1, BUCKET).astype(np.int32)
    for c in chunks[:WARMUP]:
        pred.predict_ids(c)
    served = chunks[WARMUP:]
    all_ids = served.reshape(-1)

    # flax's GroupNorm(dtype=bf16) returns bf16; autocast's group_norm runs
    # in f32, so the port's norm casts back and what follows stays bf16.
    norm_dtypes = set()
    hooks = [m.register_forward_hook(
        lambda _m, _in, out: norm_dtypes.add(out.dtype))
        for m in clf.model.modules() if isinstance(m, (ConvBlock, ResBlock))]
    pred.predict_ids(chunks[0][:8])
    for h in hooks:
        h.remove()
    check(norm_dtypes == {torch.bfloat16}, f"norm outputs {norm_dtypes}")

    for spec in KERNELS.values():
        spec["counter"].launches = 0
    norm_ops.group_norm_act_cuda.bypassed = 0
    torch.cuda.synchronize()
    request_ms, preds = [], []
    for c in served:
        t0 = time.perf_counter()
        preds.append(pred.predict_ids(c))  # returns host labels: synchronized
        request_ms.append((time.perf_counter() - t0) * 1e3)
    metrics = pred.evaluate(all_ids)
    cmap = pred.class_map(all_ids)
    launches = {name: spec["counter"].launches for name, spec in KERNELS.items()}
    buckets = 3 * REQUESTS  # the requests, evaluate(), class_map()
    check(launches["gather_windows"] == buckets,
          f"gather_windows launches {launches['gather_windows']} != "
          f"{buckets} buckets (one a bucket)")
    check(launches["group_norm_act"] == 13 * buckets
          and norm_ops.group_norm_act_cuda.bypassed == 0,
          f"group_norm_act launches {launches['group_norm_act']} != 13 a "
          f"bucket, or {norm_ops.group_norm_act_cuda.bypassed} bypassed")

    preds = np.concatenate(preds)
    targets = scene.label.reshape(-1)[all_ids].astype(np.int32)
    conf = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets),
                            cfg["Categories_Number"]).numpy()
    check(np.array_equal(conf, metrics["confusion"]),
          "evaluate() differs from the served requests")
    x, y = scene.ids_to_xy(all_ids)
    check(np.array_equal(cmap[x, y], preds), "class_map differs from requests")
    img = render_class_map(torch.from_numpy(cmap), torch.tensor(
        cfg["DATA_DICT"]["image6"]["color"], dtype=torch.uint8))
    check(tuple(img.shape) == (scene.height, scene.width, 3), "class map shape")
    aa, oa, kap, _ = aa_oa(conf)

    # The same requests with the plain gather on the card.
    for c, p in zip(served, preds.reshape(REQUESTS, BUCKET)):
        ids = torch.from_numpy(c).to(device)
        ms_b, pan_b = gather_dual(scene.ms, scene.pan, ids, scene.width,
                                  scene.patch)
        plain = clf.predict(ms_b.float(), pan_b.float()).cpu().numpy()
        check(np.array_equal(plain, p), "kernel-gather and plain-gather "
              "predictions differ")

    # Where the time goes: a traced window of a few requests.
    from torch.profiler import ProfilerActivity, profile
    traced = served[:4]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in traced:
            pred.predict_ids(c)
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    gather_us = sum(e.self_device_time_total for e in on_device
                    if "gather_family_kernel" in e.key)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:12]
    log("profile: " + json.dumps({
        "requests": len(traced), "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "gather_kernel_ms": gather_us / 1e3,
        "top_kernels_ms_calls": [[e.key[:90], e.self_device_time_total / 1e3,
                                  e.count] for e in top]}))

    # The served bf16 model and f32 on the card (TF32 off), each against
    # the same weights in f32 on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = load_config(overrides={**CFG, "precision": {
        "compute_dtype": "float32", "scene_dtype": "float32"}})
    state = clf.model.state_dict()
    card32 = build_model(cfg32).to(device, memory_format=torch.channels_last)
    card32.load_state_dict(state)
    cpu32 = build_model(cfg32)
    cpu32.load_state_dict({k: v.cpu() for k, v in state.items()})
    ids = torch.from_numpy(served[0][:64]).to(device)
    ms_b, pan_b = gather_ops.gather_dual_fast(scene.ms, scene.pan, ids,
                                              scene.width, scene.patch)
    with torch.inference_mode():
        on_card = card32.eval()(ms_b, pan_b).cpu()
        on_cpu = cpu32.eval()(ms_b.cpu(), pan_b.cpu())
        served16 = clf.logits(ms_b, pan_b).cpu()
    for t in (on_card, served16):
        check(bool(torch.isfinite(t).all()) and t.dtype == torch.float32
              and t.shape == on_cpu.shape, "served logits: dtype, shape or "
              "non-finite values")
    err32 = float((on_card - on_cpu).abs().max())
    check(err32 <= 1e-3, f"f32 card vs CPU logits differ by {err32}")
    err16 = float((served16 - on_cpu).abs().max())
    check(err16 <= BF16_ATOL, f"bf16 card vs f32 CPU logits differ by "
          f"{err16} > {BF16_ATOL}")
    agree16 = float((served16.argmax(-1) == on_cpu.argmax(-1)).float().mean())

    # The window's rate: every anchor served over the sum of request times.
    result = {"requests": REQUESTS, "bucket": BUCKET,
              "anchors_per_s": REQUESTS * BUCKET / sum(request_ms) * 1e3,
              "request_ms_median": statistics.median(request_ms),
              "request_ms_max": max(request_ms), "oa": oa, "aa": aa,
              "kappa": kap, "f32_card_vs_cpu_max_abs": err32,
              "bf16_card_vs_f32_cpu_max_abs": err16,
              "bf16_card_vs_f32_cpu_argmax_agree": agree16,
              "logit_scale": float(on_cpu.abs().max()),
              "launches": launches, "request_ms": request_ms}
    log(f"serving: {json.dumps(result)}")
    return launches


def phase_norm() -> dict:
    """B5 at gmfnet-w64-p16's 13 norms, B 4096: checked against the plain
    version and timed (``tools/norm_probe.run``); the unit row with the
    13-launch sum of a request."""
    try:
        probe = norm_probe.run("cuda", BUCKET)
    except RuntimeError as e:
        check(False, f"norm: {e}")
    for row in probe["norms"]:
        log(f"norm: {json.dumps(row)}")
    log(f"norm: a request's 13 launches (ms): {json.dumps(probe['request'])}")
    unit = probe["unit"]
    return {"max_abs_err": None, "max_ulps": max(
                r["max_ulps"] for r in probe["norms"]),
            "bit_equal_share": min(r["bit_equal_share"]
                                   for r in probe["norms"]),
            "ms": unit["ms"], "plain_ms": unit["plain_ms"],
            "library_ms": unit["library_ms"], "bound_ms": unit["bound_ms"],
            "bound_by": f"bytes, {unit['moved_bytes'] / 1e6:.1f} MB",
            "request": probe["request"]}


def phase_attn() -> tuple[dict, int]:
    """B6 at Swin-T's cores, B 1024: checked against the plain version and
    timed (``tools/attn_probe.run``); a served ``swin_t_dual`` request's
    launches and the profiler's linkage (``tools/attn_probe.serve``);
    returns the unit row with a request's sums, and the served launches."""
    try:
        probe = attn_probe.run("cuda", 1024)
        served = attn_probe.serve("cuda", 1024)
    except RuntimeError as e:
        check(False, f"attn: {e}")
    for row in probe["cores"]:
        log(f"attn: {json.dumps(row)}")
    log(f"attn: a request's 24 launches (ms): {json.dumps(probe['request'])}"
        f"; f32 body: {json.dumps(probe['f32'])}")
    log(f"attn: served swin_t_dual request: {json.dumps(served)}")
    unit = probe["unit"]
    return {"max_abs_err": unit["max_abs_err"],
            "max_rel_err": max(r["max_rel_err"] for r in probe["cores"]),
            "ms": unit["ms"], "plain_ms": unit["plain_ms"],
            "library_ms": unit["library_ms"], "bound_ms": unit["bound_ms"],
            "bound_by": f"bytes, {unit['moved_bytes'] / 1e6:.1f} MB",
            "request": probe["request"], "served": served}, \
        served["launches"]


def _pool_out(hm: int, wm: int, patch: int) -> tuple[int, int]:
    return -(-(hm - patch + 1) // 2), -(-(wm - patch + 1) // 2)


def phase_pool(scene, device) -> dict:
    """phase_pool_cuda vs phase_pool_ref: bit-equal at the image6 w32
    shape (bf16 and f32), an odd-output, a wide, a large-patch and an
    unaligned-pixel geometry; timings."""
    hm, wm = int(scene.ms.shape[0]), int(scene.ms.shape[1])  # 2016 x 2116
    ps = scene.patch
    gen = torch.Generator(device=device).manual_seed(11)

    def feats(h2, w2, c4, dtype):
        return torch.randn((h2, w2, c4), generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    cases = [("image6 w32 bf16", -(-hm // 2), -(-wm // 2), 128, ps,
              torch.bfloat16, _pool_out(hm, wm, ps)),
             ("image6 w32 f32", -(-hm // 2), -(-wm // 2), 128, ps,
              torch.float32, _pool_out(hm, wm, ps)),
             ("odd 37x45 4C=64 p8 bf16", 37, 45, 64, 8, torch.bfloat16,
              _pool_out(73, 89, 8)),
             ("wide 4C=256 p32 f32", 60, 84, 256, 32, torch.float32,
              _pool_out(119, 167, 32)),
             ("large ph 4C=64 p34 f32 (shared body)", 45, 50, 64, 34,
              torch.float32, _pool_out(89, 99, 34)),
             ("unaligned 4C=12 p16 bf16 (24-byte pixels)", 100, 150, 12, 16,
              torch.bfloat16, _pool_out(199, 299, 16))]
    worst = 0.0
    for tag, h2, w2, c4, patch, dtype, (ni, nj) in cases:
        f = feats(h2, w2, c4, dtype)
        got = pool_ops.phase_pool_cuda(f, patch, ni, nj)
        want = pool_ops.phase_pool_ref(f, patch, ni, nj)
        torch.cuda.synchronize()
        worst = max(worst, _max_err(got, want))
        check(got.shape == want.shape == (ni, nj, c4) and got.dtype == dtype,
              f"phase_pool {tag}: shape or dtype")
        check(torch.equal(got, want), f"phase_pool {tag}: kernel != plain "
              f"(max {_max_err(got, want)})")
        log(f"kernels: phase_pool {tag}: bit-equal {tuple(f.shape)} -> "
            f"{tuple(got.shape)}")

    # Timing at the main path's shape, bf16: kernel, plain version, and one
    # avg_pool2d over the full-resolution (1, C, 2*H2, 2*W2) map (same
    # window means; no s2d packing and another rounding).
    h2, w2 = -(-hm // 2), -(-wm // 2)
    ni, nj = _pool_out(hm, wm, ps)
    f = feats(h2, w2, 128, torch.bfloat16)
    full = dense_fusion.depth_to_space(f, 2).permute(2, 0, 1)[None]
    full = full.contiguous()
    runs = {
        "plain": lambda i: pool_ops.phase_pool_ref(f, ps, ni, nj),
        "kernel": lambda i: pool_ops.phase_pool_cuda(f, ps, ni, nj),
        "library": lambda i: torch.nn.functional.avg_pool2d(full, ps, 1),
    }
    med, times = time_in_turns(runs, iters=10)
    moved = (h2 * w2 + ni * nj) * 128 * f.element_size()
    bound = moved / HBM_BYTES_PER_S * 1e3
    plan = pool_ops.launch_plan(
        h2, w2, 128, ps, ni, nj, f.element_size(),
        sms=torch.cuda.get_device_properties(device).multi_processor_count)
    log(f"kernels: phase_pool image6 w32 bf16 plan: {plan}")
    log(f"kernels: phase_pool image6 w32 bf16 ms median of 6: kernel "
        f"{med['kernel']:.4f} plain {med['plain']:.4f} library "
        f"{med['library']:.4f} bound {bound:.4f} ({moved / 1e6:.1f} MB); "
        f"all: {json.dumps(times)}")
    return {"max_abs_err": worst, "ms": med["kernel"], "plain_ms": med["plain"],
            "library_ms": med["library"], "bound_ms": bound,
            "bound_by": "bytes"}


def phase_dense(scene, device) -> dict:
    """Serve the image6 dense class map from an artifact; returns the
    launch counts of the timed maps."""
    cfg = load_config(overrides=DENSE_CFG)
    model = init_params(build_model(cfg),
                        torch.Generator().manual_seed(cfg["seed"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/dense_image6.zip"
        save_artifact(path, cfg, model)
        clf = load_artifact(path, device)
    check(clf.is_map and clf.manifest["dense_bands"] == 0,
          "dense artifact: not a whole-scene map artifact")
    for _ in range(DENSE_WARMUP):
        ScenePredictor(clf, scene).class_map()

    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    map_ms = []
    for _ in range(DENSE_MAPS):
        pred = ScenePredictor(clf, scene)  # a fresh cache: renders anew
        t0 = time.perf_counter()
        cmap = pred.class_map()  # host labels: synchronized
        map_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: spec["counter"].launches
                for name, spec in KERNELS.items()}
    check(launches["phase_pool"] == DENSE_MAPS,
          f"phase_pool launches {launches['phase_pool']} != {DENSE_MAPS} "
          f"maps")
    ncls = int(cfg["Categories_Number"])
    check(cmap.shape == (scene.height, scene.width) and cmap.min() >= 0
          and cmap.max() < ncls, "dense class map: shape or class range")
    metrics = pred.evaluate()
    check(metrics["pixels"] == int(np.count_nonzero(scene.label))
          and int(metrics["confusion"].sum()) == metrics["pixels"],
          "dense evaluate(): pixel count")

    # The same map with the plain pool on the card.
    dense_fusion.phase_pool = pool_ops.phase_pool_ref
    try:
        plain = ScenePredictor(clf, scene).class_map()
    finally:
        dense_fusion.phase_pool = pool_ops.phase_pool
    check(np.array_equal(plain, cmap), "kernel-pool and plain-pool maps "
          f"differ at {int((plain != cmap).sum())} pixels")

    # Four row bands: one pool launch per band.
    prog = DensePrograms(clf.model, scene.patch)
    before = pool_ops.phase_pool_cuda.launches
    banded = prog.class_map_streamed(scene.ms, scene.pan, DENSE_BANDS)
    band_launches = pool_ops.phase_pool_cuda.launches - before
    banded = banded.cpu().numpy()
    check(band_launches == DENSE_BANDS, f"streamed map: {band_launches} "
          f"pool launches for {DENSE_BANDS} bands")
    band_agree = float((banded == cmap).mean())
    check(band_agree >= 0.999, f"streamed map agrees {band_agree} < 0.999")

    # Where the time goes: a profile of two maps.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            ScenePredictor(clf, scene).class_map()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    pool_us = sum(e.self_device_time_total for e in on_device
                  if "phase_pool_kernel" in e.key)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:14]
    log("profile dense: " + json.dumps({
        "maps": 2, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us, "pool_kernel_ms": pool_us / 1e3,
        "pool_share_of_busy": pool_us / busy_us,
        "top_kernels_ms_calls": [[e.key[:90], e.self_device_time_total / 1e3,
                                  e.count] for e in top]}))

    # Precision on a 96x96 MS crop and its PAN: the served bf16 model and
    # f32 on the card (TF32 off), against f32 on the CPU, same weights.
    r0 = c0 = min(1000, scene.height - 96) // 2 * 2
    ms = scene.ms[r0:r0 + 96, c0:c0 + 96]
    pan = scene.pan[4 * r0:4 * (r0 + 96), 4 * c0:4 * (c0 + 96)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = load_config(overrides={**DENSE_CFG, "precision": {
        "compute_dtype": "float32", "scene_dtype": "float32"}})
    state = clf.model.state_dict()
    card32 = build_model(cfg32).to(device)
    card32.load_state_dict(state)
    cpu32 = build_model(cfg32)
    cpu32.load_state_dict({k: v.cpu() for k, v in state.items()})
    with torch.inference_mode():
        on_card = card32.eval()(ms, pan, scene.patch).cpu()
        on_cpu = cpu32.eval()(ms.cpu(), pan.cpu(), scene.patch)
        served16 = clf.logits(ms, pan).cpu()
    for t in (on_card, served16):
        check(bool(torch.isfinite(t).all()) and t.dtype == torch.float32
              and t.shape == on_cpu.shape
              == (97 - scene.patch, 97 - scene.patch, ncls),
              "dense logits: dtype, shape or non-finite values")
    err32 = float((on_card - on_cpu).abs().max())
    check(err32 <= 1e-3, f"dense f32 card vs CPU logits differ by {err32}")
    err16 = float((served16 - on_cpu).abs().max())
    check(err16 <= DENSE_BF16_ATOL, f"dense bf16 card vs f32 CPU logits "
          f"differ by {err16} > {DENSE_BF16_ATOL}")
    agree16 = float((served16.argmax(-1) == on_cpu.argmax(-1)).float().mean())

    pixels = scene.height * scene.width
    med = statistics.median(map_ms)
    result = {"maps": DENSE_MAPS, "map_ms_median": med,
              "map_ms_max": max(map_ms), "pixels": pixels,
              "pixels_per_s": pixels / med * 1e3,
              "oa": metrics["oa"], "aa": metrics["aa"],
              "kappa": metrics["kappa"], "launches": launches,
              "bands": DENSE_BANDS, "band_launches": band_launches,
              "band_vs_whole_agree": band_agree,
              "f32_card_vs_cpu_max_abs": err32,
              "bf16_card_vs_f32_cpu_max_abs": err16,
              "bf16_card_vs_f32_cpu_argmax_agree": agree16,
              "logit_scale": float(on_cpu.abs().max()),
              "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
              "map_ms": map_ms}
    log(f"dense: {json.dumps(result)}")
    return launches


def _host_ops(fn, what: str, top_n: int) -> dict:
    """One ``torch.profiler`` window with host tracing over ``fn()``: the
    ``top_n`` host ops by their own CPU time (the tracing itself slows the
    host, so this window's wall time is not the run's)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host_us = sum(e.self_cpu_time_total for e in ops)
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top_n]
    return {"window": what, "traced_wall_ms": wall_us / 1e3,
            "host_ops_ms": host_us / 1e3,
            "ops": sum(e.count for e in ops),
            "top_host_ops_self_ms_calls": [[e.key[:60],
                                            e.self_cpu_time_total / 1e3,
                                            e.count] for e in top]}


def _profile(fn, what: str, top_n: int) -> dict:
    """One ``torch.profiler`` window over ``fn()``: wall and device-busy
    time, the idle share and the ``top_n`` device ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    gather_us = sum(e.self_device_time_total for e in on_device
                    if "gather_family_kernel" in e.key)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"window": what, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3, "busy_share": busy_us / wall_us,
            "idle_share": 1 - busy_us / wall_us,
            "gather_kernel_ms": gather_us / 1e3,
            "top_device_ops_ms_calls": [[e.key[:90],
                                         e.self_device_time_total / 1e3,
                                         e.count] for e in top]}


def _op_profile(fn, what: str, top_n: int) -> dict:
    """One ``torch.profiler`` window over ``fn()`` with host and device
    tracing: the ``top_n`` operators by the device time of the kernels
    they launch themselves (which names the operator behind a generic
    elementwise kernel)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"window": what,
            "ops_device_ms": sum(e.self_device_time_total for e in ops) / 1e3,
            "top_ops_device_ms_calls": [[e.key[:60],
                                         e.self_device_time_total / 1e3,
                                         e.count] for e in top]}


def _parity_losses(scene, streams: tuple, device, rng) -> dict:
    """Three Adam steps from seeded w64 weights on three image6 batches of
    256: f32 on the card (TF32 off) and on the CPU, bf16 on the card;
    gmfnet over ``streams`` (MS, PAN), tri_net over (MS, PAN, MSPAN), or
    dqtl over the two-stage solver's four streams (qua_loss)."""
    from dmfusion_torch.train.optim import make_optimizer
    labeled, _ = split_labels(scene.label)
    ids = torch.from_numpy(rng.choice(labeled, PARITY_STEPS * TRAIN_BATCH,
                                      replace=False).astype(np.int32))
    labels = torch.from_numpy(scene.label.reshape(-1)[ids.numpy()]
                              .astype(np.int64))
    over, programs, bf16_atol = {
        2: (CFG, DualPrograms, TRAIN_BF16_ATOL),
        3: ({**CFG, "model_name": "tri_net"}, TriPrograms, TRAIN_BF16_ATOL),
        4: ({**CFG, "model_name": "dqtl"}, QuadPrograms,
            QUAD_TRAIN_BF16_ATOL)}[len(streams)]
    windows = [programs.gathers[1](*streams, b.to(device), scene.width,
                                   scene.patch)
               for b in ids.split(TRAIN_BATCH)]
    if programs is QuadPrograms:  # dqtl takes the four streams as one batch
        windows = [(torch.cat(win),) for win in windows]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tag, dev, dtype in (("f32_cpu", torch.device("cpu"), "float32"),
                            ("f32_card", device, "float32"),
                            ("bf16_card", device, "bfloat16")):
        cfg = load_config(overrides={**over, "device": "cpu", "precision": {
            "compute_dtype": dtype, "scene_dtype": "float32"}})
        model = build_model(cfg).to(dev)
        if dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        prog = programs(model, make_optimizer(cfg, model.parameters(),
                                              PARITY_STEPS),
                        cfg, scene.width, scene.patch)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        losses = [prog.train_step([t.to(dev) for t in win], lab.to(dev))
                  for win, lab in zip(windows, labels.split(TRAIN_BATCH))]
        out[tag] = torch.stack(losses).cpu()
    for t in out.values():
        check(bool(torch.isfinite(t).all()), "parity: non-finite loss")
    gap32 = float((out["f32_card"] - out["f32_cpu"]).abs().max())
    gap16 = float((out["bf16_card"] - out["f32_card"]).abs().max())
    check(gap32 <= 1e-3, f"f32 card vs CPU train losses differ by {gap32}")
    check(gap16 <= bf16_atol, f"bf16 vs f32 train losses differ by "
          f"{gap16} > {bf16_atol}")
    return {"model": over.get("model_name", "gmfnet"), "steps": PARITY_STEPS,
            "batch": TRAIN_BATCH,
            "losses": {k: v.tolist() for k, v in out.items()},
            "f32_card_vs_cpu_max_abs": gap32, "f32_tolerance": 1e-3,
            "bf16_vs_f32_card_max_abs": gap16,
            "bf16_tolerance": bf16_atol}


def phase_train(scene, device) -> int:
    """Train gmfnet w64 on image6 through ``python -m dmfusion_torch.cli``'s
    ``main`` (2 epochs, test), check what it writes and computes,
    reload its best weights, hold the gather route and the card's losses
    against their plain versions, and time it; returns B1's launches over
    the CLI run."""
    from dmfusion_torch import cli
    from dmfusion_torch.solvers import build_solver
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = cli.main(["--set", *TRAIN_SET, f"expo_result={tmp}/"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        test_s = solver.test_time

        log(f"train: the CLI run took {run_s:.2f} s; epochs "
            f"{rec['EpochTime']} s, losses {rec['Loss']}")
        width = solver.model.ms_res.conv.out_channels
        check(width == 64 and cfg["patch_size"] == 16
              and cfg["batchsize"] == TRAIN_BATCH
              and cfg["precision"]["compute_dtype"] == "bfloat16"
              and solver.scene.ms.dtype == torch.float32
              and solver.device.type == "cuda", "train: not the default run")
        check(rec["Epoch"] == [0, 1], f"train: epochs {rec['Epoch']}")
        check(all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
              f"train: non-finite losses {rec['Loss']} {rec['ValLoss']}")
        check(rec["Loss"][1] < rec["Loss"][0],
              f"train: epoch 1 loss {rec['Loss'][1]} not below epoch 0's "
              f"{rec['Loss'][0]}")
        check(int(solver.test_matrix.sum()) == len(split.test),
              "train: test matrix does not sum to the test split")
        aa, oa, kap, _ = solver.last_result
        check(oa >= 0.5, f"train: test OA {oa} < 0.5")
        out = cfg["RESULT_output"]
        files = ["0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                 "0_records.json"]
        for f in files:
            check(os.path.isfile(os.path.join(out, f)), f"train: no {f}")
        check(os.path.isfile(cfg["RESULT_excel"]), "train: no workbook")
        _keep_workbook(cfg, "train", oa)

        def nb(n, b):
            return -(-n // b)
        ev = solver._eval_round_to()
        check(ev == EVAL_BATCH, f"train: eval batches of {ev}")
        batches = {"train": nb(len(split.train), TRAIN_BATCH) * 2,
                   "val": nb(len(split.valid), ev) * 2,
                   "test": nb(len(split.test), ev)}
        want = sum(batches.values())  # one a gathered batch
        check(launches["gather_windows"] == want,
              f"train: {launches['gather_windows']} B1 launches, the split "
              f"sizes give {want} ({batches})")

        # B1 at the train path's shape: a shuffled train batch and the
        # last one, padded with masked anchor 0, against the plain gather.
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        real_last = int(tb[2][-1].sum())
        check(0 < real_last < TRAIN_BATCH,
              f"train: the last train batch holds {real_last} anchors")
        ms, pan = solver.scene_args
        for tag, row in (("shuffled", 0), (f"last, {real_last} real", -1)):
            got = gather_ops.gather_dual_fast(ms, pan, tb[0][row],
                                              solver.scene.width,
                                              solver.scene.patch)
            want = gather_dual(ms, pan, tb[0][row], solver.scene.width,
                               solver.scene.patch)
            for g, r in zip(got, want):
                check(g.shape == r.shape and torch.equal(g, r),
                      f"train: B1 != plain on the {tag} train batch "
                      f"(max {_max_err(g, r)})")
            log(f"kernels: gather_dual B={TRAIN_BATCH} {tag} train batch: "
                f"bit-equal ms {tuple(got[0].shape)} pan "
                f"{tuple(got[1].shape)}")

        # The gather route: val confusion through B1 and the plain gather.
        vb = solver.batches(split.valid, cfg["color_batchsize"],
                            round_to=ev)
        vb = (vb[0], vb[1], vb[2].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_k, conf_k = solver.programs.eval_epoch(solver.scene_args, *vb)
        conf_k = conf_k.cpu()
        val_s = time.perf_counter() - t0
        plain = DualPrograms(solver.model, None, cfg, solver.scene.width,
                             solver.scene.patch, plain_gather=True)
        loss_p, conf_p = plain.eval_epoch(solver.scene_args, *vb)
        check(torch.equal(conf_k, conf_p.cpu()),
              "train: val confusion with B1 != with the plain gather")

        # The best weights (which test left in the model), reloaded
        # from their file by a fresh solver: the same confusion.
        fresh = build_solver({**cfg, "train": {**cfg["train"], "index": 0}})
        fresh.dataloader()
        fresh._use_eval_params()
        _, conf_f = fresh.programs.eval_epoch(fresh.scene_args, *vb)
        check(torch.equal(conf_f.cpu(), conf_k),
              "train: reloaded best weights give another val confusion")
        del fresh

        # Train-only time of 20 steps, then a profile of the same steps.
        steps = (tb[0][:PROFILE_STEPS], tb[1][:PROFILE_STEPS],
                 tb[2][:PROFILE_STEPS].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(solver.programs.train_epoch(solver.scene_args, *steps).mean())
        train_steps_s = time.perf_counter() - t0
        prof = _profile(lambda: solver.programs.train_epoch(
            solver.scene_args, *steps),
            f"{PROFILE_STEPS} train steps, B {TRAIN_BATCH}", 8)
        log("profile train: " + json.dumps(prof))
        host = _host_ops(lambda: solver.programs.train_epoch(
            solver.scene_args, *(t[:HOST_STEPS] for t in steps)),
            f"{HOST_STEPS} train steps, B {TRAIN_BATCH}, host ops", 10)
        log("profile train host: " + json.dumps(host))
        # The trained solver and its run dir stay for the diagnostics
        # phase's visualize and patch-cache check.
        KEPT["train"] = (solver, tmp)
        del plain
    finally:
        _release(tmp)

    rng = np.random.default_rng(7)
    b256 = time_gather(scene, (scene.ms, scene.pan), DualPrograms.gathers,
                       TRAIN_BATCH, rng)
    parity = _parity_losses(scene, (scene.ms, scene.pan), device, rng)
    n_train = len(split.train)
    result = {
        "model": "gmfnet", "width": width, "patch": 16, "batch": TRAIN_BATCH,
        "run_s": run_s, "epoch_s": rec["EpochTime"], "loss": rec["Loss"],
        "val_loss": rec["ValLoss"], "val_oa": rec["ValOA"],
        "train_anchors": n_train, "val_anchors": len(split.valid),
        "test_anchors": len(split.test),
        "epoch1_samples_per_s": n_train / rec["EpochTime"][1],
        "train_steps": PROFILE_STEPS, "train_steps_s": train_steps_s,
        "train_samples_per_s": PROFILE_STEPS * TRAIN_BATCH / train_steps_s,
        "val_s": val_s, "test_s": test_s,
        "test_anchors_per_s": len(split.test) / test_s,
        "test_oa": oa, "test_aa": aa,
        "test_kappa": kap, "gather_batches": batches,
        "launches": launches, "b1_b256": b256,
        "parity": parity}
    log(f"train: {json.dumps(result)}")
    return launches["gather_windows"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_env(rank: int, port: int, world: int = DP_RANKS) -> None:
    """What ``torchrun`` sets for a rank of ``world`` on this host."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))


def _dp_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t``, in rank order, moved as bytes, so the
    comparison holds the kernel's bits and not the collective's types."""
    return mesh.rows(t.view(torch.uint8)).view(t.dtype)


def _dp_gather(scene, mesh) -> dict:
    """``gather_dual_sharded`` on this rank: one B1 launch a call, both
    ranks' rows bit-equal to one process's ``gather_dual_fast`` of the
    whole batch and to the plain ``gather_dual`` (``gather_windows_ref``)
    on the same ids (f32 and bf16 scenes; B 4096 with corner anchors,
    B 4160, B 1025, B 256, and anchors past the scene, clamped); then the wrapper timed
    at B 4096 and 4160 on each rank in turn, beside the plain route (the
    same shard through the plain gather), one indexing call a stream on
    the shard, and the bytes bound of the shard."""
    w, ps, n, h = scene.width, scene.patch, scene.num_pixels, scene.height
    c = int(scene.ms.shape[-1])
    rng = np.random.default_rng(11)  # the same draws on every rank
    base = rng.integers(0, n, max(DP_GATHER_B)).astype(np.int32)
    base[:6] = [0, w - 1, (h - 1) * w, n - w, 2 * w - 1, n - 1]
    cases = {f"B={b}": base[:b] for b in DP_GATHER_B}
    cases["clamped"] = np.array([n - 1, n, n + w + 3, 10 * n, 2**30, 7] * 11,
                                np.int32)
    worst = 0.0
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ms, pan = scene.ms.to(dt), scene.pan.to(dt)
        for name, ids_np in cases.items():
            ids = torch.from_numpy(ids_np).to(mesh.device)
            b = ids.shape[0]
            before = gather_ops.gather_windows_cuda.launches
            ms_p, pan_p = gather_ops.gather_dual_sharded(
                ms, pan, ids, w, ps, mesh)
            check(gather_ops.gather_windows_cuda.launches == before + 1,
                  f"train_dp: {tag} {name}: not one B1 launch on rank "
                  f"{mesh.rank}")
            check(ms_p.shape[0] == pan_p.shape[0] == mesh.per_rank(b),
                  f"train_dp: {tag} {name}: shard {tuple(ms_p.shape)}")
            rows = [_dp_rows(mesh, t)[:b] for t in (ms_p, pan_p)]
            for how, want in (
                    ("plain gather_dual", gather_dual(ms, pan, ids, w, ps)),
                    ("gather_dual_fast",
                     gather_ops.gather_dual_fast(ms, pan, ids, w, ps))):
                for got, ref in zip(rows, want, strict=True):
                    worst = max(worst, _max_err(got, ref))
                    check(got.shape == ref.shape and torch.equal(got, ref),
                          f"train_dp: {tag} {name}: the ranks' rows != one "
                          f"process's {how} on rank {mesh.rank}")
        del ms, pan
    out = {"max_abs_err": worst, "cases": sorted(cases)}
    for b in DP_GATHER_B[:2]:
        sets = [torch.from_numpy(rng.integers(0, n, b).astype(np.int32)
                                 ).to(mesh.device) for _ in range(8)]
        grids = []
        for ids in sets:
            loc = mesh.shard(ids).long()
            x, y = loc // w, loc % w
            grids.append([
                (v, (xx[:, None] + torch.arange(p, device=mesh.device)
                     )[:, :, None],
                 (yy[:, None] * ch + torch.arange(p * ch, device=mesh.device)
                  )[:, None, :])
                for v, p, ch, xx, yy in (
                    (scene.ms.reshape(scene.ms.shape[0], -1), ps, c, x, y),
                    (scene.pan, 4 * ps, 1, 4 * x, 4 * y))])
        runs = {
            "plain": lambda i: gather_dual(scene.ms, scene.pan,
                                           mesh.shard(sets[i % 8]), w, ps),
            "kernel": lambda i: gather_ops.gather_dual_sharded(
                scene.ms, scene.pan, sets[i % 8], w, ps, mesh),
            "library": lambda i: [v[r, k] for v, r, k in grids[i % 8]]}
        per = mesh.per_rank(b)
        moved = gather_probe.moved_bytes((scene.ms, scene.pan), (1, 4), per,
                                         ps)
        timed = {}
        for r in range(mesh.data):  # one rank at a time on the card
            mesh.barrier()
            if r == mesh.rank:
                timed, _ = time_in_turns(runs, iters=50)
            mesh.barrier()
        out[f"B{b}"] = {"ms": timed["kernel"], "plain_ms": timed["plain"],
                        "library_ms": timed["library"], "per_rank": per,
                        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                        "bound_by": "bytes", "bytes": moved}
    return out


def _no_tf32() -> tuple[bool, bool]:
    """Turn TF32 off; returns the flags to restore."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return flags


class _LocalMeans(DualPrograms):
    """The control of :func:`_dp_parity`: DDP's rule, each rank's own
    masked mean with the ranks' gradients averaged, which weighs the rows
    of a shard with fewer real rows more."""

    def loss(self, logits, labels_b, mask_b, count=None):
        from dmfusion_torch.train.losses import cross_entropy
        return cross_entropy(logits, labels_b, mask_b) / self.mesh.data


def _dp_parity(scene, mesh) -> dict:
    """Three SGD steps of gmfnet w64 in f32 (TF32 off) from seeded weights,
    the padded batch first (200 real: 128 on rank 0, 72 on rank 1) so that
    the next two losses see its update, then two full batches of 256,
    through the mesh and through one process on the card: losses within
    DP_LOSS_ATOL, parameters within DP_PARAM_ATOL.  The same steps under a
    mean of the ranks' own means must fall outside one of the two."""
    from dmfusion_torch.train.optim import make_optimizer
    cfg = load_config(overrides={**CFG, "schedule": {"optimizer": "SGD"},
                                 "precision": {"compute_dtype": "float32",
                                               "scene_dtype": "float32"}})
    labeled, _ = split_labels(scene.label)
    ids = np.random.default_rng(5).choice(labeled, 2 * TRAIN_BATCH + 200,
                                          replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, TRAIN_BATCH)
    first = [2, 0, 1]  # batched_ids_np pads the last batch
    chunks, mask = chunks[first], mask[first]
    labels = scene.label.reshape(-1)[chunks].astype(np.int32)
    batches = [torch.from_numpy(a).to(mesh.device)
               for a in (chunks, labels, mask.astype(np.float32))]
    tf32 = _no_tf32()
    out = {}
    for tag, cls, m in (("one_process", DualPrograms, None),
                        ("two_ranks", DualPrograms, mesh),
                        ("local_means", _LocalMeans, mesh)):
        model = build_model(cfg).to(mesh.device,
                                    memory_format=torch.channels_last)
        prog = cls(model, make_optimizer(cfg, model.parameters(),
                                         PARITY_STEPS),
                   cfg, scene.width, scene.patch, mesh=m)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        losses = prog.train_epoch((scene.ms, scene.pan), *batches)
        out[tag] = (losses.cpu(), torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]).cpu())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    def gaps(tag):
        return [float((out["one_process"][i] - out[tag][i]).abs().max())
                for i in (0, 1)]
    gap_loss, gap_param = gaps("two_ranks")
    check(gap_loss <= DP_LOSS_ATOL, f"train_dp: two ranks' SGD losses "
          f"{gap_loss} from one process's on rank {mesh.rank}")
    check(gap_param <= DP_PARAM_ATOL, f"train_dp: two ranks' parameters "
          f"{gap_param} from one process's on rank {mesh.rank}")
    control = gaps("local_means")
    check(control[0] > DP_LOSS_ATOL or control[1] > DP_PARAM_ATOL,
          f"train_dp: a mean of the ranks' own means passes the parity "
          f"check ({control}): the check cannot see a wrong reduction")
    return {"steps": PARITY_STEPS, "batch": TRAIN_BATCH,
            "padded_batch_real": 200, "padded_batch_step": 0, "losses": {
                k: v[0].tolist() for k, v in out.items()},
            "loss_max_abs": gap_loss, "loss_atol": DP_LOSS_ATOL,
            "param_max_abs": gap_param, "param_atol": DP_PARAM_ATOL,
            "local_means_loss_max_abs": control[0],
            "local_means_param_max_abs": control[1]}


def _rank_timing(mesh, run, steps: int, prof_steps: int) -> dict:
    """``run(i0, i1)`` trains steps [i0, i1) on this rank: 3 warm-up steps,
    ``steps`` timed, then on rank 0 a profile of ``prof_steps`` more, with
    the share of its wall in gloo's all-reduce and all-gather (the other
    ranks run the same steps unprofiled)."""
    from torch.profiler import ProfilerActivity, profile
    run(0, 3)
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    run(3, 3 + steps)
    torch.cuda.synchronize()
    out = {"steps": steps,
           "step_ms": (time.perf_counter() - t0) / steps * 1e3}
    window = (3 + steps, 3 + steps + prof_steps)
    mesh.barrier()
    if not mesh.is_main:
        run(*window)
        torch.cuda.synchronize()
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*window)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out.update(profile_steps=prof_steps, profile_wall_ms=wall_ms)
    for word in ("allreduce", "allgather"):
        hits = [e for e in events if e.device_type ==
                torch.autograd.DeviceType.CPU and word in
                e.key.replace("_", "").lower()]
        ms = max((e.cpu_time_total for e in hits), default=0.0) / 1e3
        out[f"{word}_ms"] = ms
        out[f"{word}_share"] = ms / wall_ms
        out[f"{word}_ops"] = [[e.key, e.cpu_time_total / 1e3, e.count]
                              for e in hits]
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_busy_share"] = sum(
        e.self_device_time_total for e in on_device) / 1e3 / wall_ms
    out["top_device_ops_ms_calls"] = [
        [e.key[:70], e.self_device_time_total / 1e3, e.count]
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total
                        )[:8]]
    return out


def _dp_steps(scene, mesh) -> dict:
    """The default run's steps on this rank (gmfnet w64, Adam, bf16, 128 of
    each batch of 256): 20 timed, after 3; then on rank 0 a profile of 5,
    with the share of its wall time spent in the gradients' all-reduce."""
    from dmfusion_torch.train.optim import make_optimizer
    cfg = load_config(overrides=CFG)
    labeled, _ = split_labels(scene.label)
    n = (3 + PROFILE_STEPS + DP_PROFILE_STEPS) * TRAIN_BATCH
    ids = np.random.default_rng(6).choice(labeled, n, replace=False)
    chunks = ids.astype(np.int32).reshape(-1, TRAIN_BATCH)
    batches = [torch.from_numpy(a).to(mesh.device) for a in (
        chunks, scene.label.reshape(-1)[chunks].astype(np.int32),
        np.ones(chunks.shape, np.float32))]
    model = build_model(cfg).to(mesh.device,
                                memory_format=torch.channels_last)
    prog = DualPrograms(model, make_optimizer(cfg, model.parameters(),
                                              chunks.shape[0]),
                        cfg, scene.width, scene.patch, mesh=mesh)
    prog.init(torch.Generator().manual_seed(cfg["seed"]))
    args = (scene.ms, scene.pan)

    def run(i0, i1):
        losses = prog.train_epoch(args, *(t[i0:i1] for t in batches))
        check(bool(torch.isfinite(losses).all()), "train_dp: non-finite loss")
    before = gather_ops.gather_windows_cuda.launches
    out = _rank_timing(mesh, run, PROFILE_STEPS, DP_PROFILE_STEPS)
    b1 = gather_ops.gather_windows_cuda.launches - before
    check(b1 == chunks.shape[0], f"train_dp: rank {mesh.rank} launched "
          f"B1 {b1} times in {chunks.shape[0]} steps")
    out.update(rank_batch=mesh.per_rank(TRAIN_BATCH), b1_launches=b1,
               samples_per_s=TRAIN_BATCH / out["step_ms"] * 1e3)
    return out


def _dp_rank(rank: int, port: int, out_dir: str) -> None:
    """One of phase train_dp's spawned ranks: join the group through
    ``maybe_initialize_distributed`` (gloo: the ranks share the card),
    build the image6 scene, and write what :func:`_dp_gather`,
    :func:`_dp_parity` and :func:`_dp_steps` found to ``rank{r}.json``."""
    _dp_env(rank, port)
    cfg = load_config(overrides={**CFG, "mesh": {"distributed": 1}})
    check(parallel.maybe_initialize_distributed(cfg),
          "train_dp: the rank did not join")
    try:
        mesh = parallel.get_mesh(cfg)
        check(mesh is not None and mesh.data == DP_RANKS
              and mesh.rank == rank and mesh.backend == "gloo"
              and mesh.device == torch.device("cuda", 0),
              f"train_dp: rank {rank}'s mesh {mesh}")
        scene = synthetic_scene(load_config(overrides=CFG),
                                device=mesh.device)
        result = {"rank": rank, "device": str(mesh.device),
                  "backend": mesh.backend, "gather": _dp_gather(scene, mesh),
                  "parity": _dp_parity(scene, mesh),
                  "steps": _dp_steps(scene, mesh)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        parallel.shutdown()


def _dp_cli(tmp: str, args: list[str], phase: str = "train_dp",
            timeout: float = DP_TIMEOUT, nprocs: int = DP_RANKS) -> dict:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    <nprocs> -m dmfusion_torch.cli <args> mesh.distributed=1
    expo_result=<tmp>/`` (``args`` end in ``--set`` overrides), as a user
    starts it; returns its seconds, output and the ranks' reports."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nprocs), "-m", "dmfusion_torch.cli",
           *args, "mesh.distributed=1", f"expo_result={tmp}/"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"{phase}: torchrun exit {proc.returncode}"
          f"\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    tag = "[dmfusion] rank report "
    reports = sorted((json.loads(line.split(tag, 1)[1])
                      for line in proc.stdout.splitlines() if tag in line),
                     key=lambda r: r["rank"])
    joined = [line for line in proc.stdout.splitlines()
              if line.startswith("[dmfusion] rank ") and tag not in line]
    return {"run_s": run_s, "reports": reports, "joined": joined}


def _spawn_ranks(fn, tmp: str, phase: str, timeout: float,
                 nprocs: int = DP_RANKS, during=None) -> list[dict]:
    """``fn(rank, port, tmp)`` in ``nprocs`` spawned processes, all killed
    by ``timeout`` s; ``during()`` runs in this process meanwhile.
    Returns each rank's ``rank{r}.json``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(_free_port(), tmp), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout
    try:
        if during is not None:
            during()
        while not ctx.join(timeout=5):
            check(time.perf_counter() < deadline,
                  f"{phase}: the spawned ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(nprocs):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def phase_train_dp() -> tuple[int, dict]:
    """The mesh's data axis on the card: two ranks on ``cuda:0`` over gloo.
    Spawned ranks hold the sharded gather, SGD parity and the step times.
    Returns B1's launches in the ranks' timed steps (both ranks) and the
    wrapper's times on rank 0.  The CLI under torchrun on the data axis is
    driven by train_dp_streams, train_dp_maps (gmfnet_conv per anchor:
    the same programs and sharded gather) and train_tp (gmfnet and the
    two-stage solver on the model axis)."""
    log(f"train_dp: {DP_RANKS} ranks share one card ({card_line()}) over "
        "gloo: NCCL takes one rank a device.  These numbers hold the path's "
        "correctness and say nothing of scaling across cards.")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_dp_")
    try:
        ranks = _spawn_ranks(_dp_rank, tmp, "train_dp", DP_TIMEOUT)
        for r in ranks:
            log(f"train_dp: rank {r['rank']} on {r['device']} over "
                f"{r['backend']}: sharded gather bit-equal "
                f"({', '.join(r['gather']['cases'])}, f32 and bf16); "
                f"{json.dumps({k: r['gather'][k] for k in ('B4096', 'B4160')})}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b1 = sum(r["steps"]["b1_launches"] for r in ranks)
    result = {
        "ranks": DP_RANKS, "card": card_line(), "backend": "gloo",
        "model": "gmfnet", "width": 64, "patch": 16, "batch": TRAIN_BATCH,
        "rank_batch": -(-TRAIN_BATCH // DP_RANKS), "b1_launches": b1,
        "gather": {r["rank"]: r["gather"] for r in ranks},
        "parity": ranks[0]["parity"],
        "steps": {r["rank"]: r["steps"] for r in ranks},
        "phase_s": time.perf_counter() - t_phase}
    log(f"train_dp: {json.dumps(result)}")
    g = ranks[0]["gather"]
    return b1, {"max_abs_err": max(r["gather"]["max_abs_err"]
                                   for r in ranks),
                **{k: g[k] for k in ("B4096", "B4160")}}


# -- phase train_dp_streams: tri, quad and stage 1 on the data axis ---------
def _digest(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over ``t``'s 32-bit words, on its device: equal
    tensors give equal digests; a changed word changes them."""
    v = t.contiguous().view(torch.int32).reshape(-1).long()
    return torch.stack([v.sum(), (v * (v >> 9)).sum()])


def _views(scene, streams: tuple, shard: torch.Tensor) -> list:
    """One indexing call's (view, rows, columns) a stream at the shard's
    anchors: MS-geometry streams at the anchor, PAN-geometry ones (more
    than twice MS's rows) at 4x it, each at its own window."""
    w, ps, dev = scene.width, scene.patch, shard.device
    loc = shard.long()
    x, y = loc // w, loc % w
    grids = []
    for v in streams:
        s4 = 4 if v.shape[0] > 2 * scene.ms.shape[0] else 1
        ch = int(v.shape[-1]) if v.ndim == 3 else 1
        p = s4 * ps
        grids.append((v.reshape(v.shape[0], -1),
                      (s4 * x[:, None] + torch.arange(p, device=dev)
                       )[:, :, None],
                      (s4 * y[:, None] * ch
                       + torch.arange(p * ch, device=dev))[:, None, :]))
    return grids


def _dps_gather(scene, mspan, quad, mesh) -> dict:
    """The tri and quad gathers of the mesh's programs on this rank: the
    family's kernel wrapper given ``mesh.shard_rows(b)``, one B1 launch a
    call; both ranks' rows bit-equal to the plain ``gather_tri`` and
    ``gather_quad`` (``gather_windows_ref``) of the whole batch on the same
    ids (f32 and bf16 scenes; B 4096 with corner anchors, B 4160, B 1025,
    B 256, and anchors past the scene, clamped); then each wrapper timed at
    B 4096 on each rank in turn, beside the plain route on the shard, one
    indexing call a stream on the shard, and the shard's bytes bound."""
    w, ps, n, h = scene.width, scene.patch, scene.num_pixels, scene.height
    c = int(scene.ms.shape[-1])
    rng = np.random.default_rng(12)  # the same draws on every rank
    base = rng.integers(0, n, max(DP_GATHER_B)).astype(np.int32)
    base[:6] = [0, w - 1, (h - 1) * w, n - w, 2 * w - 1, n - 1]
    cases = {f"B={b}": base[:b] for b in DP_GATHER_B}
    cases["clamped"] = np.array([n - 1, n, n + w + 3, 10 * n, 2**30, 7] * 11,
                                np.int32)
    # (plain, kernel wrapper, streams, anchor scales)
    fams = {"tri": (gather_tri, gather_ops.gather_tri_fast,
                    (scene.ms, scene.pan, mspan), (1, 4, 4)),
            "quad": (gather_quad, gather_ops.gather_quad_fast, quad,
                     (1, 1, 1, 1))}
    worst = 0.0
    for fam, (plain, fast, streams, _) in fams.items():
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = tuple(t.to(dt) for t in streams)
            for name, ids_np in cases.items():
                ids = torch.from_numpy(ids_np).to(mesh.device)
                b = ids.shape[0]
                before = gather_ops.gather_windows_cuda.launches
                parts = fast(*args, ids, w, ps, mesh.shard_rows(b))
                check(gather_ops.gather_windows_cuda.launches == before + 1,
                      f"train_dp_streams: {fam} {tag} {name}: not one B1 "
                      f"launch on rank {mesh.rank}")
                check(all(p.shape[0] == mesh.per_rank(b) for p in parts),
                      f"train_dp_streams: {fam} {tag} {name}: shards "
                      f"{[tuple(p.shape) for p in parts]}")
                want = plain(*args, ids, w, ps)
                for got, ref in zip(parts, want, strict=True):
                    got = _dp_rows(mesh, got)[:b]
                    worst = max(worst, _max_err(got, ref))
                    check(got.shape == ref.shape and torch.equal(got, ref),
                          f"train_dp_streams: {fam} {tag} {name}: the ranks' "
                          f"rows != the plain gather's on rank {mesh.rank}")
            del args
    out = {"max_abs_err": worst, "cases": sorted(cases)}
    b = DP_GATHER_B[0]
    per = mesh.per_rank(b)
    for fam, (plain, fast, streams, scales) in fams.items():
        sets = [torch.from_numpy(rng.integers(0, n, b).astype(np.int32)
                                 ).to(mesh.device) for _ in range(8)]
        grids = [_views(scene, streams, mesh.shard(s)) for s in sets]
        runs = {
            "plain": lambda i: plain(*streams, mesh.shard(sets[i % 8]), w,
                                     ps),
            "kernel": lambda i: fast(*streams, sets[i % 8], w, ps,
                                     mesh.shard_rows(b)),
            "library": lambda i: [v[r, q] for v, r, q in grids[i % 8]]}
        moved = gather_probe.moved_bytes(streams, scales, per, ps)
        timed = {}
        for r in range(mesh.data):  # one rank at a time on the card
            mesh.barrier()
            if r == mesh.rank:
                timed, _ = time_in_turns(runs, iters=50)
            mesh.barrier()
        out[fam] = {"b": b, "ms": timed["kernel"], "plain_ms": timed["plain"],
                    "library_ms": timed["library"], "per_rank": per,
                    "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "bytes": moved}
    return out


class _ShardQuaLoss(QuadPrograms):
    """The control of :func:`_dps_quad_parity`: each rank's qua_loss on its
    own shard with the ranks' gradients summed, as if the loss were a sum
    over rows."""

    def _shard(self, labels_b, mask_b):
        return DualPrograms._shard(self, labels_b, mask_b)

    def loss(self, logits, labels_b, mask_b, count=None):
        from dmfusion_torch.train.losses import qua_loss
        return qua_loss(logits, labels_b.shape[0], labels_b, self.cfg, mask_b)


def _dps_quad_parity(scene, quad, mesh) -> dict:
    """Three SGD steps of dqtl w64 in f32 (TF32 off) from seeded weights,
    the padded batch first (200 real: 128 on rank 0, 72 on rank 1), then
    two full batches of 256, through the mesh and through one process on
    the card: losses within DPS_QUAD_LOSS_ATOL, parameters within
    DPS_QUAD_PARAM_ATOL; each rank's qua_loss on its own shard with the
    gradients summed must fall outside one of the two.  Then, with the
    trained weights, one eval batch of 4096 (4000 real) through both: the
    loss sum within 1e-5 relative, the five confusions (at most one anchor
    in a thousand moved) and the fused prediction (an argmax agreement of
    at least 0.999: the two forward passes run at other batch sizes)."""
    from dmfusion_torch.train.optim import make_optimizer
    cfg = load_config(overrides={**CFG, "model_name": "dqtl",
                                 "schedule": {"optimizer": "SGD"},
                                 "precision": {"compute_dtype": "float32",
                                               "scene_dtype": "float32"}})
    labeled, _ = split_labels(scene.label)
    real, n_ev = TRAIN_BATCH * 25 // 32, EVAL_BATCH - 96
    ids = np.random.default_rng(5).choice(
        labeled, 2 * TRAIN_BATCH + real + n_ev, replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids[:2 * TRAIN_BATCH + real],
                                     TRAIN_BATCH)
    first = [2, 0, 1]  # batched_ids_np pads the last batch
    chunks, mask = chunks[first], mask[first]
    ev_chunks, ev_mask, _ = batched_ids_np(ids[-n_ev:], EVAL_BATCH)

    def on_card(chunks, mask):
        labels = scene.label.reshape(-1)[chunks].astype(np.int32)
        return [torch.from_numpy(a).to(mesh.device)
                for a in (chunks, labels, mask.astype(np.float32))]
    batches, ev = on_card(chunks, mask), on_card(ev_chunks, ev_mask)
    tf32 = _no_tf32()
    out, evals = {}, {}
    for tag, cls, m in (("one_process", QuadPrograms, None),
                        ("two_ranks", QuadPrograms, mesh),
                        ("shard_loss", _ShardQuaLoss, mesh)):
        model = build_model(cfg).to(mesh.device,
                                    memory_format=torch.channels_last)
        prog = cls(model, make_optimizer(cfg, model.parameters(),
                                         PARITY_STEPS),
                   cfg, scene.width, scene.patch, mesh=m)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        losses = prog.train_epoch(quad, *batches)
        out[tag] = (losses.cpu(), torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]).cpu())
        if tag != "shard_loss":
            loss_sum, confs = prog.eval_epoch(quad, *ev)
            evals[tag] = (float(loss_sum), confs.cpu(),
                          prog.predict(quad, ev[0]).cpu()[0, :n_ev])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32

    def gaps(tag):
        return [float((out["one_process"][i] - out[tag][i]).abs().max())
                for i in (0, 1)]
    gap_loss, gap_param = gaps("two_ranks")
    check(gap_loss <= DPS_QUAD_LOSS_ATOL, f"train_dp_streams: two ranks' "
          f"qua_loss {gap_loss} from one process's on rank {mesh.rank}")
    check(gap_param <= DPS_QUAD_PARAM_ATOL, f"train_dp_streams: two ranks' "
          f"dqtl parameters {gap_param} from one process's on rank "
          f"{mesh.rank}")
    control = gaps("shard_loss")
    check(control[0] > DPS_QUAD_LOSS_ATOL or control[1] > DPS_QUAD_PARAM_ATOL,
          f"train_dp_streams: a rank's qua_loss on its own shard passes the "
          f"parity check ({control}): the check cannot see the wrong loss")
    (l1, c1, p1), (l2, c2, p2) = evals["one_process"], evals["two_ranks"]
    eval_rel = abs(l1 - l2) / abs(l1)
    moved = int((c1 - c2).abs().sum() / 2)
    agree = float((p1 == p2).float().mean())
    check(int(c2[0].sum()) == n_ev and eval_rel <= 1e-5 and agree >= 0.999
          and moved <= 5 * n_ev // 1000, f"train_dp_streams: the mesh's quad eval "
          f"(loss sum {l2} against {l1}, {moved} anchors moved in the five "
          f"confusions, prediction agreement {agree}) on rank {mesh.rank}")
    return {"steps": PARITY_STEPS, "batch": TRAIN_BATCH,
            "padded_batch_real": real, "losses": {
                k: v[0].tolist() for k, v in out.items()},
            "loss_max_abs": gap_loss, "loss_atol": DPS_QUAD_LOSS_ATOL,
            "param_max_abs": gap_param, "param_atol": DPS_QUAD_PARAM_ATOL,
            "shard_loss_loss_max_abs": control[0],
            "shard_loss_param_max_abs": control[1],
            "eval_loss_sum_rel": eval_rel, "eval_confusion_moved": moved,
            "predict_agreement": agree}


class _SummedGan(GanPrograms):
    """The control of :func:`_dps_gan_parity`: the ranks' gradients
    summed instead of averaged."""

    def _reduce(self, params, loss):
        loss = super()._reduce(params, loss)
        for q in params:
            q.grad *= self.mesh.data
        return loss


def _gan_tiles(quad, pic: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` (pic, pic, 4) crops of the normalized MS and pan2ms(PAN)
    streams, row by row from the scene's corner (again from the corner
    when the scene holds fewer)."""
    rows, cols = quad[0].shape[0] // pic, quad[0].shape[1] // pic
    at = [(i // cols % rows * pic, i % cols * pic) for i in range(n)]
    return tuple(torch.stack([s[r:r + pic, c:c + pic] for r, c in at])
                 for s in quad[:2])


def _gan_nets(cfg, device) -> list:
    return [build_model(cfg, n).to(device, memory_format=torch.channels_last)
            for n in ("generator", "generator", "discriminator",
                      "discriminator")]


def _dps_gan_parity(quad, mesh, phase: str = "train_dp_streams") -> dict:
    """Three ``GanPrograms`` steps at gan_width 32, f32 (TF32 off), on
    GAN_PARITY_PIC crops, 4 tiles a step (2 a rank), from seeded weights
    and the same noise (drawn on the CPU), through the mesh and through
    one process on the card: the losses within DPS_GAN_LOSS_RTOL, Adam's
    moments within DPS_GAN_MOMENT_RTOL of the largest, the parameters
    within Adam's step bound; summing the ranks' gradients must move the
    moments past their limit."""
    pic, bs = GAN_PARITY_PIC, 2 * mesh.data
    m, p = (t.reshape(PARITY_STEPS, bs, pic, pic, -1)
            for t in _gan_tiles(quad, pic, PARITY_STEPS * bs))
    gen = torch.Generator().manual_seed(CFG["seed"])
    noise = [tuple(torch.randn(t.shape[1:], generator=gen).to(mesh.device)
                   for t in (m, p)) for _ in range(PARITY_STEPS)]
    cfg = load_config(overrides={**CFG, "gan_width": GAN_WIDTH, "precision": {
        "compute_dtype": "float32"}})
    lr = float(cfg["dqtl"]["lr"])
    tf32 = _no_tf32()
    out = {}
    for tag, cls, mm in (("one_process", GanPrograms, None),
                         ("two_ranks", GanPrograms, mesh),
                         ("summed", _SummedGan, mesh)):
        prog = cls(*_gan_nets(cfg, mesh.device), cfg, mesh=mm)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        draws = iter(noise)
        prog.noise = lambda _m, _p: next(draws)
        r = prog.train_epoch(m, p, "all")
        opts = (prog.opt_g, prog.opt_d)
        out[tag] = {
            "losses": torch.stack([r["d_loss"], r["g_loss"]], 1).cpu(),
            "fakes": torch.cat([r["fake_pan"].reshape(-1),
                                r["fake_ms"].reshape(-1)]).cpu(),
            "params": torch.cat([q.detach().reshape(-1)
                                 for o in opts for g in o.param_groups
                                 for q in g["params"]]).cpu(),
            "moments": torch.cat([o.state[q][k].reshape(-1)
                                  for o in opts for g in o.param_groups
                                  for q in g["params"]
                                  for k in ("exp_avg", "exp_avg_sq")]).cpu()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    one = out["one_process"]

    def gap(tag, key):
        return float((out[tag][key] - one[key]).abs().max())
    loss_rel = float(((out["two_ranks"]["losses"] - one["losses"]).abs()
                      / one["losses"].abs()).max())
    gaps = {k: gap("two_ranks", k) for k in ("fakes", "params", "moments")}
    scale = float(one["moments"].abs().max())
    control = gap("summed", "moments") / scale
    check(loss_rel <= DPS_GAN_LOSS_RTOL and gaps["moments"]
          <= DPS_GAN_MOMENT_RTOL * scale
          and gaps["params"] <= 4 * lr * PARITY_STEPS,
          f"{phase}: the mesh's GAN steps (losses {loss_rel} relative, "
          f"{gaps}, moments up to {scale}) from one process's on rank "
          f"{mesh.rank}")
    check(control > DPS_GAN_MOMENT_RTOL, f"{phase}: summed GAN gradients "
          f"pass the parity check (moments {control} of the largest "
          "apart)")
    return {"gan_width": GAN_WIDTH, "pic": pic, "batch": bs,
            "steps": PARITY_STEPS,
            "losses_d_g": {k: v["losses"].tolist() for k, v in out.items()},
            "loss_max_rel": loss_rel, "loss_rtol": DPS_GAN_LOSS_RTOL,
            "fakes_max_abs": gaps["fakes"], "param_max_abs": gaps["params"],
            "param_bound": 4 * lr * PARITY_STEPS,
            "moments_max_abs": gaps["moments"], "moments_max": scale,
            "moment_rtol": DPS_GAN_MOMENT_RTOL,
            "summed_moments_max_rel": control,
            "mesh_digest": _digest(out["two_ranks"]["params"]).tolist()}


def _dps_steps(scene, mspan, quad, mesh) -> dict:
    """The runs' steps on this rank, at the config's widths and bf16: a tri
    step (tri_net w64, Adam, 128 rows of each batch of 256; one B1 launch),
    a quad step (dqtl w64, qua_loss on the batch's logits rebuilt from the
    ranks'; one launch), a GAN step (gan_width 32, pic 128, 2 tiles of
    each batch of 4): DPS_STEPS (the GAN: DPS_GAN_STEPS) timed after 3,
    and a profile of DPS_PROFILE_STEPS (3) on rank 0."""
    from dmfusion_torch.train.optim import make_optimizer
    labeled, _ = split_labels(scene.label)
    out = {}
    n = 3 + DPS_STEPS + DPS_PROFILE_STEPS
    rng = np.random.default_rng(6)
    for fam, cls, name, args in (("tri", TriPrograms, "tri_net",
                                  (scene.ms, scene.pan, mspan)),
                                 ("quad", QuadPrograms, "dqtl", quad)):
        cfg = load_config(overrides={**CFG, "model_name": name})
        chunks = rng.choice(labeled, n * TRAIN_BATCH, replace=False).astype(
            np.int32).reshape(n, TRAIN_BATCH)
        batches = [torch.from_numpy(a).to(mesh.device) for a in (
            chunks, scene.label.reshape(-1)[chunks].astype(np.int32),
            np.ones(chunks.shape, np.float32))]
        model = build_model(cfg).to(mesh.device,
                                    memory_format=torch.channels_last)
        prog = cls(model, make_optimizer(cfg, model.parameters(), n), cfg,
                   scene.width, scene.patch, mesh=mesh)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        before = gather_ops.gather_windows_cuda.launches

        def run(i0, i1, prog=prog, args=args, batches=batches):
            losses = prog.train_epoch(args, *(t[i0:i1] for t in batches))
            check(bool(torch.isfinite(losses).all()),
                  f"train_dp_streams: non-finite {fam} loss")
        out[fam] = _rank_timing(mesh, run, DPS_STEPS, DPS_PROFILE_STEPS)
        out[fam]["b1_launches_a_step"] = (
            gather_ops.gather_windows_cuda.launches - before) / n
        check(out[fam]["b1_launches_a_step"] == 1,
              f"train_dp_streams: {out[fam]['b1_launches_a_step']} B1 "
              f"launches a {fam} step")
        out[fam]["rank_batch"] = mesh.per_rank(TRAIN_BATCH)
        del prog, model
    cfg = load_config(overrides={**CFG, "gan_width": GAN_WIDTH})
    steps = 3 + DPS_GAN_STEPS + 3
    m, p = (t.reshape(steps, GAN_BATCH, GAN_PIC, GAN_PIC, -1)
            for t in _gan_tiles(quad, GAN_PIC, steps * GAN_BATCH))
    gans = GanPrograms(*_gan_nets(cfg, mesh.device), cfg, mesh=mesh)
    gans.init(torch.Generator().manual_seed(cfg["seed"]))

    def run_gan(i0, i1):
        r = gans.train_epoch(m[i0:i1], p[i0:i1], "none")
        check(bool(torch.isfinite(r["g_loss"]).all()),
              "train_dp_streams: non-finite GAN loss")
    out["gan"] = _rank_timing(mesh, run_gan, DPS_GAN_STEPS, 3)
    out["gan"]["rank_batch"] = GAN_BATCH // mesh.data
    return out


def _dps_rank(rank: int, port: int, out_dir: str) -> None:
    """One of phase train_dp_streams' spawned ranks: join the group, build
    the image6 scene, MSPAN (the same bits on every rank, by digest) and
    the four quad streams over seeded stage-1 stand-ins, and write what
    :func:`_dps_gather`, :func:`_dps_quad_parity`, :func:`_dps_gan_parity`
    and :func:`_dps_steps` found to ``rank{r}.json``."""
    _dp_env(rank, port)
    cfg = load_config(overrides={**CFG, "mesh": {"distributed": 1}})
    check(parallel.maybe_initialize_distributed(cfg),
          "train_dp_streams: the rank did not join")
    try:
        mesh = parallel.get_mesh(cfg)
        check(mesh is not None and mesh.data == DP_RANKS
              and mesh.rank == rank and mesh.backend == "gloo"
              and mesh.device == torch.device("cuda", 0),
              f"train_dp_streams: rank {rank}'s mesh {mesh}")
        scene = synthetic_scene(load_config(overrides=CFG),
                                device=mesh.device)
        mspan = mspan_scene(scene, CFG["seed"])
        digests = mesh.rows(_digest(mspan)[None])
        check(bool((digests == digests[0]).all()),
              f"train_dp_streams: the ranks' MSPAN differ ({digests})")
        quad = quad_streams(scene, *gan_scenes(scene), mesh.device)
        result = {"rank": rank, "device": str(mesh.device),
                  "backend": mesh.backend,
                  "mspan_digest": digests[0].tolist(),
                  "gather": _dps_gather(scene, mspan, quad, mesh),
                  "quad_parity": _dps_quad_parity(scene, quad, mesh),
                  "gan_parity": _dps_gan_parity(quad, mesh),
                  "steps": _dps_steps(scene, mspan, quad, mesh)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        parallel.shutdown()


# The splitting solver of each (city, seed), built once for the mesh phases'
# CLI runs (they all split image6): its scene build is the cost.  The runs
# of a phase check at once, in threads (:func:`_cli_runs`).
_SPLIT_SOLVERS: dict = {}
_SPLIT_LOCK = threading.Lock()


def _dps_split(args: list[str]):
    """The split the CLI run of ``args`` (``--set`` overrides last) draws,
    by a solver of its city and seed that keeps only the labels."""
    from dmfusion_torch.config import parse_overrides
    from dmfusion_torch.solvers import BaseSolver
    sets = [a for a in args[args.index("--set") + 1:]
            if not a.startswith("mesh.")]  # the split of one process
    cfg = {**load_config(overrides=parse_overrides(sets)),
           "RESULT_output": tempfile.gettempdir()}
    key = (cfg["data_city"], cfg["seed"])
    with _SPLIT_LOCK:
        if key not in _SPLIT_SOLVERS:
            _SPLIT_SOLVERS[key] = BaseSolver(cfg)
            _SPLIT_SOLVERS[key].scene = None  # the split reads the labels
        base = _SPLIT_SOLVERS[key]
        base.cfg, base.time = cfg, cfg["index"]
        base.dataloader()
        return cfg, base.split


def _mesh_reports(run: dict, phase: str, solver: str, b1: int,
                  b2: int = 0, data: int = DP_RANKS, model: int = 1) -> int:
    """Each rank's report of a CLI run under torchrun: on ``cuda:0`` over
    gloo, a ``data x model`` mesh, the solver, and ``b1`` B1 and ``b2`` B2
    launches (as the split gives them); returns the ranks' B1 launches."""
    reports = run["reports"]
    check([r["rank"] for r in reports] == list(range(data * model)),
          f"{phase}: rank reports {reports}")
    for r in reports:
        check(r["device"] == "cuda:0" and r["backend"] == "gloo"
              and r["world"] == data * model and r["mesh_data"] == data
              and r["mesh_model"] == model and r["solver"] == solver,
              f"{phase}: rank {r['rank']} ran on {r}")
        check(r["gather_windows_launches"] == b1
              and r["phase_pool_launches"] == b2,
              f"{phase}: {solver} rank {r['rank']} launched B1 "
              f"{r['gather_windows_launches']} and B2 "
              f"{r['phase_pool_launches']} times, the split gives {b1} and "
              f"{b2}")
    return sum(r["gather_windows_launches"] for r in reports)


def _mesh_cli_run(tmp: str, args: list[str], model: str, files: list[str],
                  phase: str, timeout: float, test: bool = True,
                  nprocs: int = DP_RANKS, val_oa_min: float = 0.5):
    """A CLI run of ``model`` under torchrun on ``nprocs`` ranks
    (:func:`_dp_cli`): its result tree and output ``files``, finite records
    of one epoch with a val OA of at least ``val_oa_min`` and, with
    ``test``, a test matrix of the test split with OA >= 0.5.  Returns the
    run, its config, its split and what it measured."""
    run = _dp_cli(tmp, args, phase, timeout, nprocs)
    cfg, split = _dps_split(args)
    name = f"{cfg['data_city']}_tr{cfg['train_rate']}_ep1_bs{TRAIN_BATCH}"
    _listing(tmp, [name], "result tree", phase)
    root = os.path.join(tmp, name)
    _listing(root, [f"{model}__0_output"]
             + [f"{model}__0_result.xlsx"] * test, f"{model} run", phase)
    out = os.path.join(root, f"{model}__0_output")
    _listing(out, files, f"{model} output", phase)
    with open(os.path.join(out, "0_records.json")) as f:
        rec = json.load(f)
    check(rec["Epoch"] == [0] and all(np.isfinite(rec["Loss"]
                                                  + rec["ValLoss"]))
          and rec["ValOA"][-1] >= val_oa_min,
          f"{phase}: {model} records {rec}")
    result = {"run_s": run["run_s"], "epoch_s": rec["EpochTime"],
              "loss": rec["Loss"], "val_loss": rec["ValLoss"], "out": out,
              "val_oa": rec["ValOA"],
              "color_s": max(r["color_s"] for r in run["reports"]),
              "joined": run["joined"], "reports": run["reports"]}
    if test:
        matrix = np.load(os.path.join(out, "0_matrix.npy"))
        check(int(matrix.sum()) == len(split.test),
              f"{phase}: the {model} test matrix does not sum to the split")
        aa, oa, kap, _ = aa_oa(matrix)
        check(oa >= 0.5, f"{phase}: {model} test OA {oa} < 0.5")
        test_s = max(r["test_s"] for r in run["reports"])
        result.update(test_oa=oa, test_aa=aa, test_kappa=kap, test_s=test_s,
                      test_anchors_per_s=len(split.test) / test_s)
    return run, cfg, split, result


def _listing(path: str, want: list[str], what: str,
             phase: str = "train_dp_streams") -> None:
    got = sorted(os.listdir(path))
    check(got == sorted(want), f"{phase}: {what} {got}")


def _cli_runs(tmp: str, fns: dict, phase: str) -> dict:
    """Each ``fns[tag](dir)`` (a CLI run under torchrun and its checks) at
    once, in threads, each in a directory of its own under ``tmp``: their
    start-ups overlap, and their seconds are read beside each other.  The
    parent launches no kernel meanwhile.  Returns each run's result."""
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    with ThreadPoolExecutor(len(fns)) as pool:
        futures = {}
        for tag, fn in fns.items():
            d = os.path.join(tmp, tag)
            os.makedirs(d)
            futures[tag] = pool.submit(fn, d)
        runs = {tag: f.result() for tag, f in futures.items()}
    launches = {n: spec["counter"].launches for n, spec in KERNELS.items()}
    check(not any(launches.values()),
          f"{phase}: the parent launched {launches}")
    return runs


def _dps_tri_run(tmp: str) -> dict:
    """tri_net trained and colored (the unlabeled pixels) by two ranks
    through torchrun (:func:`_mesh_cli_run`, no test), one B1 launch a
    gathered batch on each rank."""
    files = ["0_curweights.pt", "0_pic_1.png", "0_pic_2.png",
             "0_records.json", "0_weights.pt"]
    run, _, split, out = _mesh_cli_run(tmp, DPS_TRI_SET, "tri_net", files,
                                       "train_dp_streams", DPS_TIMEOUT,
                                       test=False)
    batches = {"train": -(-len(split.train) // TRAIN_BATCH),
               "val": -(-len(split.valid) // EVAL_BATCH),
               "color": -(-len(split.unlabeled) // EVAL_BATCH)}
    want = sum(batches.values())
    b1 = _mesh_reports(run, "train_dp_streams", "main", want)
    return {**out, "gather_batches_per_rank": batches,
            "b1_launches_per_rank": want, "b1_launches": b1}


def _dps_twostage_run(tmp: str, args: list[str] = DPS_TWOSTAGE_SET,
                      phase: str = "train_dp_streams",
                      timeout: float = DPS_TIMEOUT, nprocs: int = DP_RANKS,
                      model: int = 1) -> dict:
    """Both stages of the two-stage solver by ``nprocs`` ranks through
    torchrun (``args``; a ``data x model`` mesh of ``nprocs // model`` x
    ``model``), without test: one result tree and one weights dir; the GAN
    scenes of the scene's shape, finite in [0, 1]; finite records; one B1
    launch a gathered batch of stage 2 on each rank."""
    run = _dp_cli(tmp, args, phase, timeout, nprocs)
    cfg, split = _dps_split(args)
    epochs = int(cfg["epoch"])
    name = f"image6_tr{cfg['train_rate']}_ep{epochs}_bs{TRAIN_BATCH}"
    wname = cfg["dqtl"]["WEIGHTS"].strip("/")
    _listing(tmp, [name, wname], "two-stage result tree", phase)
    root = os.path.join(tmp, name)
    _listing(root, ["dqtl__0_output"], "two-stage run", phase)
    out = os.path.join(root, "dqtl__0_output")
    _listing(out, ["0_curweights.pt", "0_records.json", "0_weights.pt"],
             "two-stage output", phase)
    wdir = os.path.join(tmp, wname)
    d = cfg["dqtl"]
    _listing(wdir, [d[k] for k in ("check_gH", "check_gZ", "check_dH",
                                   "check_dZ")]
             + ["fake_ms.png", "fake_pan.png", "msgan.npy", "pan.npy",
                "pangan.npy", "saved_images"], "weights dir", phase)
    _listing(os.path.join(wdir, "saved_images"),
             ["f_m_0.png", "f_p_0.png", "m.png", "p.png"], "sample grids",
             phase)
    size = (2001, 2101, 4)
    for f in ("msgan.npy", "pangan.npy"):
        arr = np.load(os.path.join(wdir, f))
        check(arr.shape == size and arr.dtype == np.float32
              and bool(np.isfinite(arr).all()) and 0 <= arr.min()
              and arr.max() <= 1, f"{phase}: {f} {arr.shape} "
              f"{arr.dtype} [{arr.min()}, {arr.max()}]")
    with open(os.path.join(out, "0_records.json")) as f:
        rec = json.load(f)
    check(rec["Epoch"] == list(range(epochs))
          and all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
          f"{phase}: two-stage records {rec}")
    batches = {"train": len(split.train) // TRAIN_BATCH * epochs,
               "val": -(-len(split.valid) // EVAL_BATCH) * epochs}
    b1 = _mesh_reports(run, phase, "twostage", sum(batches.values()),
                       data=nprocs // model, model=model)
    gan_epochs = int(cfg["dqtl"]["epochs"])
    for r in run["reports"]:
        check(r["stage1_epochs"] == gan_epochs and r["stage1_s"] > 0,
              f"{phase}: rank {r['rank']}'s stage 1 {r}")
    return {"run_s": run["run_s"],
            "stage1_s": max(r["stage1_s"] for r in run["reports"]),
            "stage1_epochs": gan_epochs, "stage2_epochs": epochs,
            "epoch_s": rec["EpochTime"],
            "loss": rec["Loss"], "val_loss": rec["ValLoss"],
            "val_oa": rec["ValOA"], "gather_batches_per_rank": batches,
            "b1_launches_per_rank": sum(batches.values()),
            "b1_launches": b1, "reports": run["reports"]}


def phase_train_dp_streams() -> tuple[int, dict]:
    """The tri and quad arities and stage 1 on the data axis: two ranks on
    ``cuda:0`` over gloo.  Spawned ranks hold the tri and quad shard
    gathers, the quad and GAN parity with one process (and their
    controls) and the step times; then tri_net, and both stages of the
    two-stage solver, are trained by ``torchrun`` through the CLI, the two
    runs at once (tri_net also colors).  Returns B1's launches in the two CLI runs (both ranks)
    and the wrappers' times on rank 0."""
    log(f"train_dp_streams: {DP_RANKS} ranks share one card ({card_line()}) "
        "over gloo: NCCL takes one rank a device.  These numbers hold the "
        "paths' correctness and say nothing of scaling across cards.")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_dp_streams_")
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_dps_rank, tmp, "train_dp_streams", DPS_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        for r in ranks:
            g = r["gather"]
            log(f"train_dp_streams: rank {r['rank']} on {r['device']} over "
                f"{r['backend']}: tri and quad shard gathers bit-equal "
                f"({', '.join(g['cases'])}, f32 and bf16); "
                f"{json.dumps({k: g[k] for k in ('tri', 'quad')})}")
        runs = _cli_runs(tmp, {"tri": _dps_tri_run,
                               "twostage": _dps_twostage_run},
                         "train_dp_streams")
        for tag in runs:
            log(f"train_dp_streams: the {tag} run under torchrun took "
                f"{runs[tag]['run_s']:.2f} s, val OA "
                f"{runs[tag]['val_oa']}, B1 "
                f"{runs[tag]['b1_launches_per_rank']} launches a rank")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b1 = sum(r["b1_launches"] for r in runs.values())
    result = {
        "ranks": DP_RANKS, "card": card_line(), "backend": "gloo",
        "ranks_s": ranks_s, "mspan_digest": ranks[0]["mspan_digest"],
        "gather": {r["rank"]: r["gather"] for r in ranks},
        "quad_parity": ranks[0]["quad_parity"],
        "gan_parity": ranks[0]["gan_parity"],
        "steps": {r["rank"]: r["steps"] for r in ranks},
        "tri_run": runs["tri"], "twostage_run": runs["twostage"],
        "b1_launches": b1, "phase_s": time.perf_counter() - t_phase}
    log(f"train_dp_streams: {json.dumps(result)}")
    g = ranks[0]["gather"]
    return b1, {"max_abs_err": max(r["gather"]["max_abs_err"]
                                   for r in ranks),
                **{k: g[k] for k in ("tri", "quad")}}

# -- phase train_dp_maps: the dense bands and gmfnet_conv on the data axis --
class _NnMesh(parallel.Mesh):
    """The control of :func:`_dpm_parity`: the window sums added by
    ``torch.distributed.nn``'s ``all_reduce``, whose backward sums every
    rank's gradient into each rank's sums (twice the features' gradient on
    two ranks)."""

    def sum_live(self, t):
        import torch.distributed.nn
        return torch.distributed.nn.all_reduce(t)


def _dense_state() -> dict:
    """The seeded w32 weights of DENSE_CFG, on the CPU."""
    return init_params(build_model(load_config(overrides=DENSE_CFG)),
                       torch.Generator().manual_seed(DENSE_CFG["seed"])
                       ).state_dict()


def _dense_model(state: dict, device, dtype: str, **over):
    """A dense_fusion w32 model with ``state``, in ``dtype``, on the card,
    and its config."""
    cfg = load_config(overrides={**DENSE_CFG, **over, "precision": {
        "compute_dtype": dtype, "scene_dtype": "float32"}})
    model = build_model(cfg)
    model.load_state_dict(state)
    return model.to(device, memory_format=torch.channels_last), cfg


def _dpm_parity(scene, mesh) -> dict:
    """Two SGD steps of dense_fusion w32 in f32 (TF32 off) from seeded
    weights on train_dense's crop, which bands on the ranks, through the
    mesh and through one process on the card: losses within DPM_LOSS_RTOL,
    parameters within DPM_PARAM_RTOL and DPM_PARAM_ATOL.  The window sums
    added through ``torch.distributed.nn`` must fall outside them."""
    from dmfusion_torch.train.optim import make_optimizer
    ms, pan, label = _dense_crop(scene, DENSE_CROP)
    plan = DensePrograms(None, scene.patch).band_plan(ms.shape[0], mesh.data)
    check(plan is not None, "train_dp_maps: the crop does not band")
    labeled = np.flatnonzero(label.reshape(-1)).astype(np.int32)
    ids = np.random.default_rng(12).choice(labeled, (2, TRAIN_BATCH),
                                           replace=False)
    batches = [torch.from_numpy(a).to(mesh.device) for a in (
        ids, label.reshape(-1)[ids].astype(np.int32),
        np.ones(ids.shape, np.float32))]
    state = _dense_state()
    tf32 = _no_tf32()
    out = {}
    for tag, m in (("one_process", None), ("two_ranks", mesh),
                   ("nn_all_reduce", _NnMesh(*vars(mesh).values()))):
        model, cfg = _dense_model(state, mesh.device, "float32",
                                  schedule={"optimizer": "SGD"})
        prog = DensePrograms(model, scene.patch, cfg=cfg, mesh=m,
                             optimizer=make_optimizer(cfg, model.parameters(),
                                                      2))
        losses = prog.train_epoch((ms, pan), *batches)
        out[tag] = (losses.cpu(), torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]).cpu())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32

    def gaps(tag):
        (l0, p0), (l1, p1) = out["one_process"], out[tag]
        return {"loss_max_rel": float(((l1 - l0) / l0).abs().max()),
                "param_max_abs": float((p1 - p0).abs().max()),
                "param_excess": float(((p1 - p0).abs() / (
                    DPM_PARAM_ATOL + DPM_PARAM_RTOL * p0.abs())).max())}

    def within(g):
        return g["loss_max_rel"] <= DPM_LOSS_RTOL and g["param_excess"] <= 1
    mine, control = gaps("two_ranks"), gaps("nn_all_reduce")
    check(within(mine), f"train_dp_maps: two ranks' dense SGD steps part "
          f"from one process's on rank {mesh.rank}: {mine}")
    check(not within(control), f"train_dp_maps: the window sums through "
          f"torch.distributed.nn pass the parity check ({control}): the "
          "check cannot see twice the gradient")
    return {"crop": DENSE_CROP, "plan": list(plan), "steps": 2,
            "batch": TRAIN_BATCH,
            "losses": {k: v[0].tolist() for k, v in out.items()},
            "two_ranks": mine, "nn_all_reduce": control,
            "loss_rtol": DPM_LOSS_RTOL, "param_rtol": DPM_PARAM_RTOL,
            "param_atol": DPM_PARAM_ATOL}


def _dpm_maps(scene, mesh) -> dict:
    """The class and logits maps of seeded w32 weights on the whole image6
    scene: every rank's band assembled against one process's whole map, f32
    logits (TF32 off) within DPM_LOGITS_ATOL and argmax agreement at least
    DPM_AGREE_F32, the bf16 class map's at least DPM_AGREE_BF16; B2 once a
    map on each rank; then a band's class map and the whole map timed on
    each rank in turn."""
    ms, pan = scene.ms, scene.pan
    state = _dense_state()
    tf32 = _no_tf32()
    out = {}
    for dtype, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        model, _ = _dense_model(state, mesh.device, dtype)
        whole = DensePrograms(model, scene.patch)
        banded = DensePrograms(model, scene.patch, mesh=mesh)
        before = pool_ops.phase_pool_cuda.launches
        if tag == "f32":
            ref = whole.logits_map(ms, pan)
            launched = pool_ops.phase_pool_cuda.launches
            got = banded.logits_map(ms, pan)
            err = _max_err(got, ref)
            ref, got = ref.argmax(-1), got.argmax(-1)
        else:
            ref = whole.predict_map(ms, pan)
            launched = pool_ops.phase_pool_cuda.launches
            got = banded.predict_map(ms, pan)
            err = None
        launches = pool_ops.phase_pool_cuda.launches - launched
        check(launched - before == 1 and launches == 1,
              f"train_dp_maps: {tag} maps launched B2 "
              f"{launched - before} and {launches} times on rank "
              f"{mesh.rank}, not once each")
        agree = float((got == ref).float().mean())
        want = DPM_AGREE_F32 if tag == "f32" else DPM_AGREE_BF16
        check(got.shape == ref.shape == (scene.height, scene.width)
              and agree >= want and (err is None or err <= DPM_LOGITS_ATOL),
              f"train_dp_maps: {tag} band map on rank {mesh.rank} against "
              f"the whole map: agreement {agree} (at least {want}), logits "
              f"{err} (at most {DPM_LOGITS_ATOL})")
        out[tag] = {"argmax_agree": agree, "logits_max_abs": err,
                    "b2_launches": launches}
        del ref, got
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    plan = banded.mesh_plan(ms.shape[0])

    def band_map(_):
        return banded._band_piece(
            ms, pan, plan, mesh.rank,
            lambda bm, bp: model.class_map(bm, bp, scene.patch))
    runs = {"whole": lambda _: whole.predict_map(ms, pan), "band": band_map}
    timed = {}
    for r in range(mesh.data):  # one rank at a time on the card
        mesh.barrier()
        if r == mesh.rank:
            with torch.inference_mode():
                timed, _ = time_in_turns(runs, iters=2, rounds=2, warmup=1)
        mesh.barrier()
    out.update(bf16_whole_map_ms=timed["whole"],
               bf16_band_map_ms=timed["band"], band=banded.mesh_band(
                   ms.shape[0]))
    return out


def _dpm_steps(scene, mesh) -> dict:
    """Dense steps on this rank (w32, Adam, bf16, batch 256, the whole
    scene, its band): DPM_STEPS timed after 3, then on rank 0 a profile of 5
    with the all-reduces' share; then the step's two collectives alone,
    DPM_COLLECTIVES times each: the window sums (``Mesh.sum_live`` of (256,
    4w) f32) and the features' gradients (one flat all-reduce)."""
    from dmfusion_torch.train.optim import make_optimizer
    model, cfg = _dense_model(_dense_state(), mesh.device, "bfloat16")
    labeled, _ = split_labels(scene.label)
    n = (3 + DPM_STEPS + DP_PROFILE_STEPS) * TRAIN_BATCH
    chunks = np.random.default_rng(13).choice(labeled, n, replace=False
                                              ).astype(np.int32).reshape(
        -1, TRAIN_BATCH)
    batches = [torch.from_numpy(a).to(mesh.device) for a in (
        chunks, scene.label.reshape(-1)[chunks].astype(np.int32),
        np.ones(chunks.shape, np.float32))]
    prog = DensePrograms(model, scene.patch, cfg=cfg, mesh=mesh,
                         optimizer=make_optimizer(cfg, model.parameters(),
                                                  chunks.shape[0]))
    args = (scene.ms, scene.pan)
    check(model.remat, "train_dp_maps: remat off under the mesh")

    def run(i0, i1):
        losses = prog.train_epoch(args, *(t[i0:i1] for t in batches))
        check(bool(torch.isfinite(losses).all()),
              "train_dp_maps: non-finite dense loss")
    out = _rank_timing(mesh, run, DPM_STEPS, DP_PROFILE_STEPS)
    win = torch.zeros((TRAIN_BATCH, 4 * 32), device=mesh.device)
    grads = [torch.zeros_like(p) for n_, p in model.named_parameters()
             if not n_.startswith("head")]
    for tag, fn in (("window_sums", lambda: mesh.sum_live(win)),
                    ("gradients", lambda: mesh.sum_all_(grads))):
        fn()
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(DPM_COLLECTIVES):
            fn()
        torch.cuda.synchronize()
        out[f"{tag}_all_reduce_ms"] = ((time.perf_counter() - t0)
                                       / DPM_COLLECTIVES * 1e3)
    out.update(gradient_elements=sum(g.numel() for g in grads),
               samples_per_s=TRAIN_BATCH / out["step_ms"] * 1e3)
    return out


def _dpm_rank(rank: int, port: int, out_dir: str) -> None:
    """One of phase train_dp_maps' spawned ranks: join the group, build the
    image6 scene and write what :func:`_dpm_parity`, :func:`_dpm_maps` and
    :func:`_dpm_steps` found to ``rank{r}.json``."""
    _dp_env(rank, port)
    cfg = load_config(overrides={**DENSE_CFG, "mesh": {"distributed": 1}})
    check(parallel.maybe_initialize_distributed(cfg),
          "train_dp_maps: the rank did not join")
    try:
        mesh = parallel.get_mesh(cfg)
        check(mesh is not None and mesh.data == DP_RANKS
              and mesh.rank == rank and mesh.backend == "gloo"
              and mesh.device == torch.device("cuda", 0),
              f"train_dp_maps: rank {rank}'s mesh {mesh}")
        scene = synthetic_scene(load_config(overrides=DENSE_CFG),
                                device=mesh.device)
        result = {"rank": rank, "device": str(mesh.device),
                  "backend": mesh.backend,
                  "parity": _dpm_parity(scene, mesh),
                  "maps": _dpm_maps(scene, mesh),
                  "steps": _dpm_steps(scene, mesh)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        parallel.shutdown()


def _dpm_dense_run(tmp: str) -> dict:
    """dense_fusion w32 trained, tested and colored by two ranks through
    torchrun: every rank's band as ``band_plan`` gives it, and B2 once a
    map on each rank (the val map, the test map, the color map)."""
    files = ["0_curweights.pt", "0_matrix.npy", "0_pic_1.png", "0_pic_2.png",
             "0_records.json", "0_weights.pt"]
    run, cfg, _, out = _mesh_cli_run(tmp, DPM_DENSE_SET, "dense_fusion",
                                     files, "train_dp_maps", DPM_TIMEOUT)
    ps = cfg["patch_size"]
    ms_rows = cfg["DATA_DICT"][cfg["data_city"]]["size"][0] + ps - 1
    plan = DensePrograms(None, ps).band_plan(ms_rows, DP_RANKS)
    for r in run["reports"]:
        out_start, s0, _ = DensePrograms.band_slices(plan, r["rank"], ms_rows)
        check(r["dense_band"] == {"out_start": out_start, "s0": s0,
                                  "need": plan[4], "band": plan[2]},
              f"train_dp_maps: rank {r['rank']}'s band {r['dense_band']}")
    maps = {"val": 1, "test": 1, "color": 1}
    _mesh_reports(run, "train_dp_maps", "main", 0, sum(maps.values()))
    return {**out, "maps_per_rank": maps, "b2_launches_per_rank": 3,
            "b2_launches": DP_RANKS * 3}


def _dpm_conv_run(tmp: str) -> dict:
    """gmfnet_conv at patch 47 trained and validated per anchor by two ranks
    through torchrun (no test): B1 once a gathered batch on every rank's
    shard, B2 never."""
    files = ["0_curweights.pt", "0_records.json", "0_weights.pt"]
    run, _, split, out = _mesh_cli_run(tmp, DPM_CONV_SET, "gmfnet_conv",
                                       files, "train_dp_maps", DPM_TIMEOUT,
                                       test=False)
    batches = {"train": -(-len(split.train) // TRAIN_BATCH),
               "val": -(-len(split.valid) // EVAL_BATCH)}
    want = sum(batches.values())
    b1 = _mesh_reports(run, "train_dp_maps", "main", want)
    return {**out, "gather_batches_per_rank": batches,
            "b1_launches_per_rank": want, "b1_launches": b1}


def phase_train_dp_maps() -> tuple[int, int]:
    """The dense family and gmfnet_conv on the data axis: two ranks on
    ``cuda:0`` over gloo.  Spawned ranks hold dense SGD parity with one
    process (and its control), the band maps against one process's whole
    map, and the dense step's times; then dense_fusion and gmfnet_conv are
    trained and tested by ``torchrun`` through the CLI, the two runs at
    once.  Returns B1's and
    B2's launches in the two CLI runs (both ranks)."""
    log(f"train_dp_maps: {DP_RANKS} ranks share one card ({card_line()}) "
        "over gloo: NCCL takes one rank a device.  These numbers hold the "
        "paths' correctness and say nothing of scaling across cards.")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_dp_maps_")
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_dpm_rank, tmp, "train_dp_maps", DPM_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        for r in ranks:
            log(f"train_dp_maps: rank {r['rank']} on {r['device']} over "
                f"{r['backend']}: dense SGD parity {json.dumps(r['parity'])}"
                f"; maps {json.dumps(r['maps'])}")
        runs = _cli_runs(tmp, {"dense": _dpm_dense_run,
                               "conv": _dpm_conv_run}, "train_dp_maps")
        for tag in runs:
            log(f"train_dp_maps: the {tag} run under torchrun took "
                f"{runs[tag]['run_s']:.2f} s, val OA "
                f"{runs[tag]['val_oa'][-1]:.4f}, test OA "
                f"{runs[tag].get('test_oa', 'not run')}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "ranks": DP_RANKS, "card": card_line(), "backend": "gloo",
        "ranks_s": ranks_s, "parity": ranks[0]["parity"],
        "maps": {r["rank"]: r["maps"] for r in ranks},
        "steps": {r["rank"]: r["steps"] for r in ranks},
        "dense_run": runs["dense"], "conv_run": runs["conv"],
        "phase_s": time.perf_counter() - t_phase}
    log(f"train_dp_maps: {json.dumps(result)}")
    return runs["conv"]["b1_launches"], runs["dense"]["b2_launches"]



# -- phase train_tp: the mesh's model axis -----------------------------------
_SUM_GRADS, _TAKE_RANK0 = steps_mod.sum_grads, steps_mod.take_rank0_params


def _tp_world_sum(params, mesh) -> None:
    """The control: the gradients summed over every rank (the model peers'
    shards of one shape added together, replicated gradients twice)."""
    _SUM_GRADS(params, dataclasses.replace(mesh, data_group=None))


def _tp_shard_broadcast(model, mesh) -> None:
    """The control: rank 0's shards broadcast over every rank (model index
    1 starts from model index 0's shards)."""
    if mesh is not None:
        with torch.no_grad():
            mesh.broadcast_all_(model.parameters())


def _tp_batches(label: np.ndarray, batch: int, real: int, seed: int,
                device) -> list[torch.Tensor]:
    """Three batches of ``batch`` labeled anchors, the first padded to
    ``real`` real rows: (ids, labels, mask) on the card."""
    labeled, _ = split_labels(label)
    ids = np.random.default_rng(seed).choice(labeled, 2 * batch + real,
                                             replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, batch)
    first = [2, 0, 1]  # batched_ids_np pads the last batch
    chunks, mask = chunks[first], mask[first]
    return [torch.from_numpy(a).to(device) for a in (
        chunks, label.reshape(-1)[chunks].astype(np.int32),
        mask.astype(np.float32))]


def _tp_train(mesh, cfg, args, batches, programs, m, patch=None,
              shard=True):
    """The SGD steps of ``batches`` from the seeded weights of ``cfg``'s
    model through ``programs(model, optimizer, cfg, m)`` on mesh ``m``
    (None: one process): (losses, the whole parameters flattened) on the
    CPU, and the programs.  ``patch`` swaps functions of
    ``train/steps.py`` for the run (the controls); ``shard`` False keeps
    the parameters replicated, as the two-stage solver does."""
    from dmfusion_torch.train.optim import make_optimizer
    for k, v in (patch or {}).items():
        setattr(steps_mod, k, v)
    try:
        model = build_model(cfg).to(mesh.device,
                                    memory_format=torch.channels_last)
        init_params(model, torch.Generator().manual_seed(cfg["seed"]))
        if shard:
            shard_model(model, m)
        prog = programs(model, make_optimizer(cfg, model.parameters(),
                                              batches[0].shape[0]), cfg, m)
        losses = prog.train_epoch(args, *batches)
        whole = full_state(model, dict(model.named_parameters()))
        flat = torch.cat([t.detach().reshape(-1) for t in whole.values()])
        return losses.cpu(), flat.cpu(), prog
    finally:
        steps_mod.sum_grads = _SUM_GRADS
        steps_mod.take_rank0_params = _TAKE_RANK0


def _tp_gaps(one, got) -> dict:
    (l0, p0), (l1, p1) = one, got
    return {"loss_max_rel": float(((l1 - l0) / l0).abs().max()),
            "param_max_abs": float((p1 - p0).abs().max()),
            "param_excess": float(((p1 - p0).abs() / (
                TP_PARAM_ATOL + TP_PARAM_RTOL * p0.abs())).max())}


def _tp_within(g: dict) -> bool:
    return g["loss_max_rel"] <= TP_LOSS_RTOL and g["param_excess"] <= 1


def _from_ranks(mesh, fns: list) -> list:
    """``fns[i]()`` run on rank ``i`` modulo the world, the ranks at once,
    and every result on every rank (an error is raised on every rank)."""
    world = dist.get_world_size()
    mine = {}
    for i in range(mesh.rank, len(fns), world):
        try:
            mine[i] = (True, fns[i]())
        except Exception as e:  # raised on every rank below
            mine[i] = (False, e)
    out = []
    for i in range(len(fns)):
        box = [mine.get(i)]
        dist.broadcast_object_list(box, i % world)
        ok, value = box[0]
        if not ok:
            raise value
        out.append(value)
    return out


# The controls a parity run may take: the world-group gradient sum, the
# rank-0 shard broadcast.
TP_CONTROLS = {"world_sum": {"sum_grads": _tp_world_sum},
               "shard_broadcast": {"take_rank0_params": _tp_shard_broadcast}}


def _tp_parity(mesh, name, one, cfg, args, batches, programs,
               controls=(), extra=None, shard=True):
    """``name``'s steps on the mesh against ``one``, one process's
    (losses, parameters): losses within TP_LOSS_RTOL, parameters within
    TP_PARAM_RTOL and TP_PARAM_ATOL; each of ``controls`` (TP_CONTROLS)
    must fall outside them.  ``shard`` False keeps the parameters
    replicated.  Returns the readings, the mesh's programs and
    ``extra(programs)``."""
    losses, flat, prog = _tp_train(mesh, cfg, args, batches, programs, mesh,
                                   shard=shard)
    mine = _tp_gaps(one, (losses, flat))
    check(_tp_within(mine), f"train_tp: {name}'s steps on rank {mesh.rank} "
          f"part from one process's: {mine}")
    out = {"steps": int(batches[0].shape[0]),
           "batch": int(batches[0].shape[1]),
           "real_first": int(batches[2][0].sum()),
           "losses": {"one_process": one[0].tolist(),
                      "ranks": losses.tolist()}, "ranks": mine}
    for tag in controls:
        g = _tp_gaps(one, _tp_train(mesh, cfg, args, batches, programs, mesh,
                                    TP_CONTROLS[tag], shard)[:2])
        check(not _tp_within(g), f"train_tp: {name}'s {tag} control passes "
              f"the parity check on rank {mesh.rank} ({g}): the check "
              "cannot see it")
        out[tag] = g
    return out, prog, extra(prog) if extra else None


def _peers_equal(mesh, model) -> bool:
    """Whether this rank's whole parameters equal its model peers', bit for
    bit (by :func:`_digest`)."""
    whole = full_state(model, dict(model.named_parameters()))
    d = _digest(torch.cat([t.detach().reshape(-1) for t in whole.values()]))
    peers = all_gather_rows(d[None], mesh.model, mesh.model_group)
    return bool((peers == peers[:1]).all())


def _tp_parities(scene, conv_scene, mspan, quad, mesh) -> dict:
    """f32 SGD steps on the mesh against one process (the one-process runs
    spread over the ranks, at once, and broadcast): gmfnet w64 (with the
    world-sum and shard-broadcast controls) and vit (4 heads) on image6,
    dense_fusion w32 on train_dense's crop (bands over the data axis;
    after its steps each rank's band map, B2 once a rank, against one
    process's whole map), then the rest of the zoo (TP_FAMILIES: tri_net
    with its world-sum control, gmfnet_conv at patch 47, swin_transformer,
    ct_lstm, dqtl replicated with its world-sum control, TP_ONE_STEP one
    step each), and the GAN quartet replicated (:func:`_dps_gan_parity`).
    The replicated runs' model peers end bit-equal."""
    f32 = {"schedule": {"optimizer": "SGD"},
           "precision": {"compute_dtype": "float32",
                         "scene_dtype": "float32"}}
    args = (scene.ms, scene.pan)

    def dual(model, opt, cfg, m):
        return DualPrograms(model, opt, cfg, scene.width, scene.patch,
                            mesh=m)

    def dense(model, opt, cfg, m):
        return DensePrograms(model, scene.patch, cfg=cfg, mesh=m,
                             optimizer=opt)

    def family(cls, patch=scene.patch):
        def programs(model, opt, cfg, m):
            return cls(model, opt, cfg, scene.width, patch, mesh=m)
        return programs

    ms, pan, label = _dense_crop(scene, DENSE_CROP)
    plan = DensePrograms(None, scene.patch).band_plan(ms.shape[0], mesh.data)
    check(plan is not None, "train_tp: the dense crop does not band")
    labeled = np.flatnonzero(label.reshape(-1)).astype(np.int32)
    ids = np.random.default_rng(12).choice(labeled, (2, TRAIN_BATCH),
                                           replace=False)

    def band_map(prog):
        before = pool_ops.phase_pool_cuda.launches
        got = prog.predict_map(ms, pan).cpu()
        return got, pool_ops.phase_pool_cuda.launches - before

    def batches(seed, n=3, batch=TRAIN_BATCH, real=TP_REAL):
        return [t[:n] for t in _tp_batches(scene.label, batch, real, seed,
                                           mesh.device)]
    runs = {  # name: the run's settings
        "gmfnet": {"cfg": {}, "args": args, "batches": batches(5),
                   "programs": dual,
                   "controls": ("world_sum", "shard_broadcast")},
        "vit": {"cfg": TP_VIT, "args": args,
                "batches": batches(7, batch=TP_VIT_BATCH, real=TP_VIT_REAL),
                "programs": dual},
        "dense": {"cfg": DENSE_CFG, "args": (ms, pan),
                  "batches": [torch.from_numpy(a).to(mesh.device) for a in (
                      ids, label.reshape(-1)[ids].astype(np.int32),
                      np.ones(ids.shape, np.float32))],
                  "programs": dense, "extra": band_map}}
    fam_args = {"tri": (scene.ms, scene.pan, mspan), "quad": quad,
                "single": (scene.ms,),
                "conv": (conv_scene.ms, conv_scene.pan)}
    fam_programs = {"tri": family(TriPrograms), "quad": family(QuadPrograms),
                    "single": family(SinglePrograms),
                    "conv": family(DualPrograms, conv_scene.patch),
                    "dual": dual}
    for i, (name, (kind, over, controls)) in enumerate(TP_FAMILIES.items()):
        runs[name] = {"cfg": over, "args": fam_args.get(kind, args),
                      "batches": batches(20 + i, 1 if name in TP_ONE_STEP
                                         else 3),
                      "programs": fam_programs[kind], "controls": controls,
                      "shard": kind != "quad"}
    for r in runs.values():
        r["cfg"] = load_config(overrides={**CFG, **r["cfg"], **f32})

    def one_process(name):
        r = runs[name]
        losses, flat, prog = _tp_train(mesh, r["cfg"], r["args"],
                                       r["batches"], r["programs"], None)
        extra = r.get("extra")
        return losses, flat, extra(prog) if extra else None
    t0 = time.perf_counter()
    ones = dict(zip(runs, _from_ranks(
        mesh, [lambda n=n: one_process(n) for n in runs])))
    out = {"s": {"one_process": time.perf_counter() - t0}}
    for name, r in runs.items():
        t0 = time.perf_counter()
        out[name], prog, got = _tp_parity(
            mesh, name, ones[name][:2], r["cfg"], r["args"], r["batches"],
            r["programs"], r.get("controls", ()), r.get("extra"),
            r.get("shard", True))
        if name == "dense":
            dense_got, band = got, prog.mesh_band(ms.shape[0])
        if not r.get("shard", True):
            check(_peers_equal(mesh, prog.model), f"train_tp: {name}'s "
                  f"replicated parameters on rank {mesh.rank} differ from "
                  "its model peer's")
            out[name]["peers_bit_equal"] = True
        out[name]["sharded"] = len(shard_dims(prog.model))
        out["s"][name] = time.perf_counter() - t0
        del prog
    got, ref = dense_got, ones["dense"][2]
    check(got[1] == 1, f"train_tp: the band map launched B2 {got[1]} times "
          f"on rank {mesh.rank}")
    agree = float((got[0] == ref[0]).float().mean())
    check(got[0].shape == ref[0].shape and agree >= DPM_AGREE_F32,
          f"train_tp: rank {mesh.rank}'s band map against one process's: "
          f"agreement {agree} (at least {DPM_AGREE_F32})")
    out["dense"].update(plan=list(plan), band=band, map_agree=agree,
                        b2_launches=got[1])
    t0 = time.perf_counter()
    out["gan"] = _dps_gan_parity(quad, mesh, "train_tp")
    digest = torch.tensor(out["gan"].pop("mesh_digest"))
    digests = all_gather_rows(digest[None], mesh.model, mesh.model_group)
    check(bool((digests == digests[:1]).all()), f"train_tp: the GAN's "
          f"replicated parameters on rank {mesh.rank} differ from its model "
          "peer's")
    out["gan"]["peers_bit_equal"] = True
    out["s"]["gan"] = time.perf_counter() - t0
    return out


def _tp_gather(scene, mspan, quad, mesh) -> dict:
    """B1 on this rank's data shard: ``gather_dual_sharded``,
    ``gather_tri_fast`` and ``gather_quad_fast`` given
    ``mesh.shard_rows(b)``, one launch a call, at B 4096 with corner
    anchors and at B 256: the rows bit-equal to the plain gather of the shard, and to the model
    peer's (moved as bytes)."""
    w, ps, n, h = scene.width, scene.patch, scene.num_pixels, scene.height
    base = np.random.default_rng(11).integers(0, n, 4096).astype(np.int32)
    base[:6] = [0, w - 1, (h - 1) * w, n - w, 2 * w - 1, n - 1]
    out = {"max_abs_err": 0.0}
    cases = {  # tag: (wrapper, plain gather, streams)
        "dual": (lambda *a: gather_ops.gather_dual_sharded(*a, mesh),
                 lambda *a: gather_dual(*a[:-3], mesh.shard(a[-3]),
                                        *a[-2:]),
                 (scene.ms, scene.pan)),
        "tri": (lambda *a: gather_ops.gather_tri_fast(
                    *a, mesh.shard_rows(a[-3].shape[0])),
                lambda *a: gather_tri(*a[:-3], mesh.shard(a[-3]), *a[-2:]),
                (scene.ms, scene.pan, mspan)),
        "quad": (lambda *a: gather_ops.gather_quad_fast(
                     *a, mesh.shard_rows(a[-3].shape[0])),
                 lambda *a: gather_quad(*a[:-3], mesh.shard(a[-3]), *a[-2:]),
                 quad)}
    for tag, (wrapper, plain_fn, streams) in cases.items():
        for b in (4096, TRAIN_BATCH):
            ids = torch.from_numpy(base[:b]).to(mesh.device)
            before = gather_ops.gather_windows_cuda.launches
            rows = wrapper(*streams, ids, w, ps)
            launched = gather_ops.gather_windows_cuda.launches - before
            check(launched == 1, f"train_tp: {tag} B {b}: "
                  f"{launched} B1 launches on rank {mesh.rank}")
            plain = plain_fn(*streams, ids, w, ps)
            for got, ref in zip(rows, plain, strict=True):
                out["max_abs_err"] = max(out["max_abs_err"],
                                         _max_err(got, ref))
                check(torch.equal(got, ref), f"train_tp: {tag} B {b}: "
                      f"rank {mesh.rank}'s rows != the plain gather's")
                peers = all_gather_rows(
                    got.contiguous().view(torch.uint8).reshape(1, -1),
                    mesh.model, mesh.model_group)
                check(bool((peers == peers[:1]).all()), f"train_tp: {tag} "
                      f"B {b}: rank {mesh.rank}'s rows differ from its "
                      "model peer's")
            out[f"{tag}_B{b}_rows_a_rank"] = int(rows[0].shape[0])
    return out


def _tp_shards(mesh) -> dict:
    """gmfnet w64, vit, dense_fusion w32 and every sharded model of
    TP_FAMILIES at the config's widths, sharded with Adam: every sharded
    parameter and both its moments of the shard's shape (the whole shape
    halved on its dimension), and the bytes of parameters and moments a
    rank holds beside one process's."""
    from dmfusion_torch.train.optim import make_optimizer
    out = {}
    models = [("gmfnet", {}), ("vit", TP_VIT),
              ("dense_fusion", {"model_name": "dense_fusion",
                                "model_width": 32})]
    models += [(name, over) for name, (kind, over, _) in TP_FAMILIES.items()
               if kind != "quad"]
    for name, over in models:
        cfg = load_config(overrides={**CFG, **over})
        model = build_model(cfg).to(mesh.device)
        whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
        one = 3 * sum(p.numel() * p.element_size()
                      for p in model.parameters())
        shard_model(model, mesh)
        opt = make_optimizer(cfg, model.parameters())
        dims = shard_dims(model)
        held = 0
        for n, p in model.named_parameters():
            st = opt.state[p]
            want = list(whole[n])
            if n in dims:
                want[dims[n][1]] //= mesh.model
            check(tuple(p.shape) == tuple(want)
                  and st["exp_avg"].shape == st["exp_avg_sq"].shape
                  == p.shape, f"train_tp: {name}'s {n} on rank "
                  f"{mesh.rank}: {tuple(p.shape)}, moments "
                  f"{tuple(st['exp_avg'].shape)}, want {tuple(want)}")
            held += 3 * p.numel() * p.element_size()
        check(bool(dims), f"train_tp: {name} shards nothing")
        out[name] = {"sharded": len(dims), "params": len(whole),
                     "bytes_a_rank": held, "bytes_one_process": one}
        del model, opt
    return out


def _tp_steps(scene, mspan, mesh) -> dict:
    """The default run's steps on the model axis (Adam, bf16, batch 256:
    128 rows a data index, the channels split over two model ranks), of
    gmfnet w64 and tri_net w64 (B1 once a step each): TP_STEPS timed
    after 3, then a profile on rank 0 (the collectives' share)."""
    from dmfusion_torch.train.optim import make_optimizer
    labeled, _ = split_labels(scene.label)
    n = (3 + TP_STEPS + DP_PROFILE_STEPS) * TRAIN_BATCH
    rng = np.random.default_rng(6)
    out = {"b1_launches": 0}
    for name, cls, args in (("gmfnet", DualPrograms, (scene.ms, scene.pan)),
                            ("tri_net", TriPrograms,
                             (scene.ms, scene.pan, mspan))):
        cfg = load_config(overrides={**CFG, "model_name": name})
        chunks = rng.choice(labeled, n, replace=False).astype(
            np.int32).reshape(-1, TRAIN_BATCH)
        batches = [torch.from_numpy(a).to(mesh.device) for a in (
            chunks, scene.label.reshape(-1)[chunks].astype(np.int32),
            np.ones(chunks.shape, np.float32))]
        model = build_model(cfg).to(mesh.device,
                                    memory_format=torch.channels_last)
        init_params(model, torch.Generator().manual_seed(cfg["seed"]))
        shard_model(model, mesh)
        prog = cls(model, make_optimizer(cfg, model.parameters(),
                                         chunks.shape[0]),
                   cfg, scene.width, scene.patch, mesh=mesh)

        def run(i0, i1, prog=prog, args=args, batches=batches, name=name):
            losses = prog.train_epoch(args, *(t[i0:i1] for t in batches))
            check(bool(torch.isfinite(losses).all()),
                  f"train_tp: non-finite {name} loss")
        before = gather_ops.gather_windows_cuda.launches
        got = _rank_timing(mesh, run, TP_STEPS, DP_PROFILE_STEPS)
        b1 = gather_ops.gather_windows_cuda.launches - before
        check(b1 == chunks.shape[0], f"train_tp: rank "
              f"{mesh.rank} launched B1 {b1} times in {chunks.shape[0]} "
              f"{name} steps")
        got.update(rank_batch=mesh.per_rank(TRAIN_BATCH), b1_launches=b1,
                   samples_per_s=TRAIN_BATCH / got["step_ms"] * 1e3)
        out[name] = got
        out["b1_launches"] += b1
        del prog, model
    return out


def _tp_rank(rank: int, port: int, out_dir: str) -> None:
    """One of phase train_tp's spawned ranks (data index ``rank // 2``,
    model index ``rank % 2``): join the group, build the image6 scenes
    (patch 16, its MSPAN and the four quad streams over seeded stage-1
    stand-ins; patch 47 for gmfnet_conv) and write what the parity steps,
    the B1 rows, the shards and the timed steps found to
    ``rank{r}.json``."""
    _dp_env(rank, port, TP_RANKS)
    _register_single()
    cfg = load_config(overrides={**CFG, "mesh": {"distributed": 1,
                                                 "model": TP_MODEL}})
    check(parallel.maybe_initialize_distributed(cfg),
          "train_tp: the rank did not join")
    try:
        mesh = parallel.get_mesh(cfg)
        check(mesh is not None and mesh.data == TP_RANKS // TP_MODEL
              and mesh.model == TP_MODEL and mesh.rank == rank
              and mesh.data_index == rank // TP_MODEL
              and mesh.model_index == rank % TP_MODEL
              and mesh.backend == "gloo"
              and mesh.device == torch.device("cuda", 0),
              f"train_tp: rank {rank}'s mesh {mesh}")
        secs, t0 = {}, time.perf_counter()
        scene = synthetic_scene(load_config(overrides=CFG),
                                device=mesh.device)
        conv_scene = synthetic_scene(load_config(overrides=CONV_CFG),
                                     device=mesh.device)
        mspan = mspan_scene(scene, CFG["seed"])
        quad = quad_streams(scene, *gan_scenes(scene), mesh.device)
        secs["scene"] = time.perf_counter() - t0
        tf32 = _no_tf32()
        try:
            parity = _tp_parities(scene, conv_scene, mspan, quad, mesh)
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = tf32
        del conv_scene
        result = {"rank": rank, "device": str(mesh.device),
                  "backend": mesh.backend,
                  "grid": [mesh.data_index, mesh.model_index],
                  "parity": parity}
        secs["parity"] = time.perf_counter() - t0 - sum(secs.values())
        for part, fn in (("gather", _tp_gather), ("shards", _tp_shards),
                         ("steps", _tp_steps)):
            if part == "steps":  # timed alone: after the CLI run
                t0 = time.perf_counter()
                while not os.path.exists(os.path.join(out_dir, TP_CLI_DONE)):
                    check(time.perf_counter() - t0 < TP_TIMEOUT,
                          "train_tp: the CLI run never ended")
                    time.sleep(0.2)
                secs["wait"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result[part] = {"gather": lambda: fn(scene, mspan, quad, mesh),
                            "shards": lambda: fn(mesh),
                            "steps": lambda: fn(scene, mspan, mesh)}[part]()
            secs[part] = time.perf_counter() - t0
        result["parts_s"] = secs
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        parallel.shutdown()


def _tp_reload(scene, out: str, cfg, split, rec: tuple) -> dict:
    """The CLI run's best weights loaded in one process on the card: the
    val confusion they give (loss sum, OA) over the run's val buckets,
    against the run's records."""
    from dmfusion_torch.train.checkpoint import load_checkpoint
    model = build_model(cfg).to(scene.ms.device,
                                memory_format=torch.channels_last)
    model.load_state_dict(load_checkpoint(
        os.path.join(out, "0_weights.pt"), None, strict=True))
    prog = DualPrograms(model, None, cfg, scene.width, scene.patch)
    ids, mask, _ = batched_ids_np(split.valid.astype(np.int32), EVAL_BATCH)
    labels = scene.label.reshape(-1)[ids].astype(np.int32)
    loss_sum, conf = prog.eval_epoch(
        (scene.ms, scene.pan), *(torch.from_numpy(a).to(scene.ms.device)
                                 for a in (ids, labels,
                                           mask.astype(np.float32))))
    oa = float(aa_oa(conf.cpu().numpy())[1])
    loss = float(loss_sum)
    got = {"val_oa": oa, "val_loss": loss, "run_val_oa": rec[0],
           "run_val_loss": rec[1], "oa_gap": abs(oa - rec[0]),
           "loss_rel_gap": abs(loss - rec[1]) / abs(rec[1])}
    check(int(conf.sum()) == len(split.valid)
          and got["oa_gap"] <= TP_VAL_OA_ATOL
          and got["loss_rel_gap"] <= TP_VAL_LOSS_RTOL,
          f"train_tp: the best weights in one process do not give the "
          f"run's val confusion again: {got}")
    return got


def _tp_gmfnet_run(tmp: str) -> dict:
    """gmfnet trained (one epoch, no test) by ``torchrun`` on two ranks,
    data 1 x model 2, through the CLI (B1 once a gathered batch a rank)."""
    args = ["--set", *TP_CLI_SET, f"mesh.model={TP_MODEL}"]
    run, cfg, split, cli = _mesh_cli_run(
        tmp, args, "gmfnet", ["0_curweights.pt", "0_records.json",
                              "0_weights.pt"], "train_tp",
        TP_TIMEOUT, test=False, nprocs=TP_CLI_RANKS, val_oa_min=0.0)
    batches = {"train": -(-len(split.train) // TRAIN_BATCH),
               "val": -(-len(split.valid) // EVAL_BATCH)}
    want = sum(batches.values())
    b1 = _mesh_reports(run, "train_tp", "main", want,
                       data=TP_CLI_RANKS // TP_MODEL, model=TP_MODEL)
    return {**cli, "cfg": cfg, "split": split,
            "gather_batches_per_rank": batches,
            "b1_launches_per_rank": want, "b1_launches": b1}


def phase_train_tp(scene) -> tuple[int, int]:
    """The mesh's model axis on the card.  Spawned ranks (data 2 x model
    2, sharing ``cuda:0`` over gloo) hold SGD parity with one process of
    every family (gmfnet, vit, dense_fusion and TP_FAMILIES; the controls;
    dqtl and the GAN quartet replicated, their model peers bit-equal),
    B1's dual, tri and quad rows and the shards' shapes and bytes;
    meanwhile two CLI runs under ``torchrun`` on two ranks, data 1 x model
    2, go at once: gmfnet (one epoch, no test; its best weights loaded in
    one process) and both stages of the two-stage solver (TP_TWOSTAGE_SET);
    then the spawned ranks time gmfnet's and tri_net's steps alone.
    Returns B1's launches on the path (the ranks' timed steps and both CLI
    runs) and B2's (the ranks' band maps)."""
    log(f"train_tp: {TP_RANKS} ranks (data {TP_RANKS // TP_MODEL} x model "
        f"{TP_MODEL}) share one card ({card_line()}) over gloo.  These "
        "numbers hold the path's correctness and say nothing of scaling "
        "across cards.")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_tp_")
    got = {}

    def cli_runs():
        """The two CLI runs under torchrun at once, while the spawned ranks
        hold their parity; then the flag that lets them time their steps
        alone."""
        got.update(_cli_runs(tmp, {
            "gmfnet": _tp_gmfnet_run,
            "twostage": lambda d: _dps_twostage_run(
                d, TP_TWOSTAGE_SET + [f"mesh.model={TP_MODEL}"], "train_tp",
                TP_TIMEOUT, TP_CLI_RANKS, TP_MODEL)}, "train_tp"))
        cli = got["gmfnet"]
        t0 = time.perf_counter()
        reload = _tp_reload(scene, cli.pop("out"), cli.pop("cfg"),
                            cli.pop("split"),
                            (cli["val_oa"][-1], cli["val_loss"][-1]))
        cli["reload"] = {**reload, "s": time.perf_counter() - t0}
        log(f"train_tp: the gmfnet run under torchrun took "
            f"{cli['run_s']:.2f} s, val OA {cli['val_oa'][-1]:.4f}; in one "
            f"process {json.dumps(cli['reload'])}")
        open(os.path.join(tmp, TP_CLI_DONE), "w").close()
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_tp_rank, tmp, "train_tp", TP_TIMEOUT, TP_RANKS,
                             during=cli_runs)
        ranks_s = time.perf_counter() - t0
        for r in ranks:
            log(f"train_tp: rank {r['rank']} (data, model) {r['grid']}: "
                f"parity {json.dumps(r['parity'])}; B1 rows "
                f"{json.dumps(r['gather'])}; shards "
                f"{json.dumps(r['shards'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b1_cli = sum(run["b1_launches"] for run in got.values())
    b1_ranks = sum(r["steps"]["b1_launches"] for r in ranks)
    b2 = sum(r["parity"]["dense"]["b2_launches"] for r in ranks)
    result = {
        "ranks": TP_RANKS, "grid": [TP_RANKS // TP_MODEL, TP_MODEL],
        "card": card_line(), "backend": "gloo", "ranks_s": ranks_s,
        "parity": ranks[0]["parity"], "shards": ranks[0]["shards"],
        "parts_s": {r["rank"]: r["parts_s"] for r in ranks},
        "steps": {r["rank"]: r["steps"] for r in ranks},
        "cli_runs": {k: {kk: vv for kk, vv in v.items() if kk != "reports"}
                     for k, v in got.items()},
        "b1_launches_ranks": b1_ranks, "b1_launches_cli": b1_cli,
        "b1_launches": b1_ranks + b1_cli, "b2_launches": b2,
        "phase_s": time.perf_counter() - t_phase}
    log(f"train_tp: {json.dumps(result)}")
    return b1_ranks + b1_cli, b2


def _dense_crop(scene, rows: int):
    """A ``rows`` x ``rows`` anchor crop of the padded scene, at an even
    offset: its padded MS and PAN slabs and its labels."""
    ps = scene.patch
    r0 = c0 = (scene.height - rows) // 4 * 2
    ms = scene.ms[r0:r0 + rows + ps - 1, c0:c0 + rows + ps - 1]
    pan = scene.pan[4 * r0:4 * (r0 + rows) + 4 * ps - 1,
                    4 * c0:4 * (c0 + rows) + 4 * ps - 1]
    return ms, pan, scene.label[r0:r0 + rows, c0:c0 + rows]


def _dense_crop_steps(scene, device) -> dict:
    """Three Adam steps on a crop from seeded w32 weights: f32 card (TF32
    off) against f32 CPU, bf16 card against f32 card, a full-batch step
    and steps in 2 bands."""
    from dmfusion_torch.train.optim import make_optimizer
    state = _dense_state()
    ms, pan, label = _dense_crop(scene, DENSE_CROP)
    check(DensePrograms(None, scene.patch).band_plan(ms.shape[0], 2)
          is not None, "dense crop: too small for 2 bands")
    labeled = np.flatnonzero(label.reshape(-1)).astype(np.int32)
    rng = np.random.default_rng(11)
    ids_np = rng.choice(labeled, (PARITY_STEPS, TRAIN_BATCH), replace=False)
    labels_np = label.reshape(-1)[ids_np].astype(np.int32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def steps(dev, dtype, **over):
        cfg = load_config(overrides={**DENSE_CFG, **over, "precision": {
            "compute_dtype": dtype, "scene_dtype": "float32"}})
        model = build_model(cfg)
        model.load_state_dict(state)
        if dev.type == "cuda":
            model = model.to(dev, memory_format=torch.channels_last)
        prog = DensePrograms(model, scene.patch, cfg=cfg,
                             optimizer=make_optimizer(cfg, model.parameters(),
                                                      PARITY_STEPS))
        batch = [torch.from_numpy(a).to(dev) for a in (
            ids_np, labels_np, np.ones(ids_np.shape, np.float32))]
        before = pool_ops.phase_pool_cuda.launches
        losses = prog.train_epoch((ms.to(dev), pan.to(dev)), *batch).cpu()
        check(bool(torch.isfinite(losses).all()),
              f"dense crop {dev.type} {dtype} {over}: losses {losses}")
        return losses, pool_ops.phase_pool_cuda.launches - before

    cpu = torch.device("cpu")
    out = {"f32_cpu": steps(cpu, "float32")[0],
           "f32_card": steps(device, "float32")[0],
           "bf16_card": steps(device, "bfloat16")[0],
           "f32_card_2_bands": steps(device, "float32", dense_streams=2)[0]}
    full, full_launches = steps(device, "bfloat16",
                                train={"dense_epoch": "full"})
    check(full.shape == (1,) and full_launches == 0,
          f"dense full-batch step: loss {full}, {full_launches} B2 launches")
    gap32 = float((out["f32_card"] - out["f32_cpu"]).abs().max())
    gap16 = float((out["bf16_card"] - out["f32_card"]).abs().max())
    gap_bands = float((out["f32_card_2_bands"] - out["f32_card"]).abs().max())
    check(gap32 <= 1e-3, f"dense f32 card vs CPU train losses differ by "
          f"{gap32}")
    check(gap16 <= DENSE_TRAIN_BF16_ATOL, f"dense bf16 vs f32 train losses "
          f"differ by {gap16} > {DENSE_TRAIN_BF16_ATOL}")
    check(gap_bands <= 1e-3, f"dense 2-band vs whole train losses differ by "
          f"{gap_bands}")
    return {"crop": DENSE_CROP, "steps": PARITY_STEPS, "batch": TRAIN_BATCH,
            "losses": {k: v.tolist() for k, v in out.items()},
            "full_batch_loss": float(full[0]),
            "full_batch_pool_launches": full_launches,
            "f32_card_vs_cpu_max_abs": gap32, "f32_tolerance": 1e-3,
            "bf16_vs_f32_card_max_abs": gap16,
            "bf16_tolerance": DENSE_TRAIN_BF16_ATOL,
            "bands_2_vs_whole_f32_max_abs": gap_bands,
            "bands_tolerance": 1e-3}


def phase_train_dense(scene, device) -> int:
    """Train dense_fusion w32 on image6 through ``python -m
    dmfusion_torch.cli``'s ``main`` (2 epochs, test, color), check what it
    writes and computes, hold B2 on the trained map against the plain
    pool and the card's training against the CPU, the bands and bf16, and
    time it; returns B2's launches over the CLI run."""
    from dmfusion_torch import cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_dense_")
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = cli.main(["--set", *DENSE_TRAIN_SET, f"expo_result={tmp}/"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        prog, model = solver.programs, solver.model
        log(f"train_dense: the CLI run took {run_s:.2f} s; epochs "
            f"{rec['EpochTime']} s, losses {rec['Loss']}; remat probe "
            f"{json.dumps(solver.remat_probe)}")
        check(isinstance(prog, DensePrograms)
              and model.head1_kernel.shape[0] == 32
              and cfg["patch_size"] == 16 and cfg["batchsize"] == TRAIN_BATCH
              and model.compute_dtype == torch.bfloat16
              and solver.scene.ms.dtype == torch.float32
              and solver.device.type == "cuda", "train_dense: not the w32, "
              "patch 16, bf16, f32-scene run on the card")
        probe = solver.remat_probe
        # On the card the probe measures; None means it ran out of memory.
        check(probe is not None and probe["budget_bytes"] > 0
              and probe["decision"] == ("on" if probe["peak_bytes"] is None
                                        or probe["peak_bytes"]
                                        >= 0.92 * probe["budget_bytes"]
                                        else "off"),
              f"train_dense: remat probe {probe}")
        check(model.remat == (probe["decision"] == "on"),
              "train_dense: the model's remat is not the probe's decision")
        check(rec["Epoch"] == [0, 1], f"train_dense: epochs {rec['Epoch']}")
        check(all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
              f"train_dense: non-finite losses {rec['Loss']} "
              f"{rec['ValLoss']}")
        check(int(solver.test_matrix.sum()) == len(split.test),
              "train_dense: test matrix does not sum to the test split")
        aa, oa, kap, _ = solver.last_result
        check(oa >= 0.5, f"train_dense: test OA {oa} < 0.5")
        out = cfg["RESULT_output"]
        for f in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                  "0_records.json", "0_pic_1.png", "0_pic_2.png"):
            check(os.path.isfile(os.path.join(out, f)),
                  f"train_dense: no {f}")
        check(os.path.isfile(cfg["RESULT_excel"]),
              "train_dense: no workbook")
        _keep_workbook(cfg, "train_dense", oa)
        # 2 val maps, the test map and the color map; no train step pools
        # through B2 (it refuses a tensor that needs grad).
        check(launches["phase_pool"] == 4,
              f"train_dense: {launches['phase_pool']} B2 launches, not 4")

        # The best weights (test and color left them in the model): the
        # val logits map and the class map through B2 and the plain pool.
        ms, pan = solver.scene_args
        with torch.inference_mode():
            logits_k = model(ms, pan, scene.patch)
            cmap_k = model.class_map(ms, pan, scene.patch)
            dense_fusion.phase_pool = pool_ops.phase_pool_ref
            try:
                logits_p = model(ms, pan, scene.patch)
                cmap_p = model.class_map(ms, pan, scene.patch)
            finally:
                dense_fusion.phase_pool = pool_ops.phase_pool
        check(torch.equal(logits_k, logits_p) and torch.equal(cmap_k, cmap_p),
              "train_dense: trained maps through B2 != through the plain "
              f"pool ({int((cmap_k != cmap_p).sum())} pixels)")

        # The val phase alone, then bf16 vs f32 (TF32 off) on the trained
        # map.
        vb = solver.batches(split.valid, cfg["color_batchsize"],
                            round_to=solver._eval_round_to())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.eval_epoch(solver.scene_args, vb[0], vb[1],
                              vb[2].float())[0])
        val_s = time.perf_counter() - t0
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg32 = load_config(overrides={**DENSE_CFG, "precision": {
            "compute_dtype": "float32", "scene_dtype": "float32"}})
        model32 = build_model(cfg32)
        model32.load_state_dict(state)
        model32 = model32.to(device, memory_format=torch.channels_last)
        with torch.inference_mode():
            logits32 = model32.eval()(ms, pan, scene.patch)
        del model32
        diff16 = float((logits_k - logits32).abs().max())
        agree16 = float((logits_k.argmax(-1) == logits32.argmax(-1))
                        .float().mean())
        scale = float(logits32.abs().max())
        del logits_k, logits_p, logits32, cmap_k, cmap_p
        check(agree16 >= DENSE_AGREE_MIN, f"train_dense: bf16 vs f32 argmax "
              f"agreement {agree16} < {DENSE_AGREE_MIN}")

        # Train-only time of 20 steps, then a profile of 5.
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        steps = (tb[0][:PROFILE_STEPS], tb[1][:PROFILE_STEPS],
                 tb[2][:PROFILE_STEPS].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.train_epoch(solver.scene_args, *steps).mean())
        train_steps_s = time.perf_counter() - t0
        prof = _profile(lambda: prog.train_epoch(
            solver.scene_args, *(t[:DENSE_PROFILE_STEPS] for t in steps)),
            f"{DENSE_PROFILE_STEPS} dense train steps, B {TRAIN_BATCH}", 12)
        log("profile train_dense: " + json.dumps(prof))
        ops = _op_profile(lambda: prog.train_epoch(
            solver.scene_args, *(t[:2] for t in steps)),
            f"2 dense train steps, B {TRAIN_BATCH}, by operator", 14)
        log("profile train_dense ops: " + json.dumps(ops))
        test_s, color_s = solver.test_time, solver.color_time
        del solver, prog, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    crop = _dense_crop_steps(scene, device)
    n_train = len(split.train)
    result = {
        "model": "dense_fusion", "width": 32, "patch": 16,
        "batch": TRAIN_BATCH, "run_s": run_s, "epoch_s": rec["EpochTime"],
        "loss": rec["Loss"], "val_loss": rec["ValLoss"],
        "val_oa": rec["ValOA"], "remat_probe": probe,
        "train_anchors": n_train, "val_anchors": len(split.valid),
        "test_anchors": len(split.test),
        "epoch1_samples_per_s": n_train / rec["EpochTime"][1],
        "train_steps": PROFILE_STEPS, "train_steps_s": train_steps_s,
        "train_step_ms": train_steps_s / PROFILE_STEPS * 1e3,
        "train_samples_per_s": PROFILE_STEPS * TRAIN_BATCH / train_steps_s,
        "val_s": val_s, "test_s": test_s,
        "test_anchors_per_s": len(split.test) / test_s, "color_s": color_s,
        "test_oa": oa, "test_aa": aa, "test_kappa": kap,
        "launches": launches,
        "trained_bf16_vs_f32_max_abs": diff16,
        "trained_bf16_vs_f32_argmax_agree": agree16,
        "trained_logit_scale": scale, "crop": crop}
    log(f"train_dense: {json.dumps(result)}")
    return launches["phase_pool"]


def _b1_patch47(scene, device) -> dict:
    """B1 at patch 47 (MS rows of 188 f32, 188x188 PAN windows; in bf16 the
    rows of 376 bytes copy element-wide): every family call bit-equal to
    its plain version with one launch (``tools/gather_probe.check_calls``:
    f32 and bf16, B 4096, 4093 and 256, negative and out-of-range ids,
    shards of 2 and 3 ranks, clamped explicit starts; the PAN and MS
    scenes stand in for MSPAN and the quad streams), and the dual call at
    every anchor of the bottom row and the right column; timed at B 4096
    and B 256."""
    ps, w, h = scene.patch, scene.width, scene.height
    n = scene.num_pixels
    ms2d = scene.ms.reshape(scene.ms.shape[0], -1)
    check(ms2d.shape[1] // 4 - ps + 1 == w and ps == 47,
          f"train_conv: scene {tuple(ms2d.shape)} is not padded for 47")
    try:
        gather_probe.check_calls(
            {"ms": scene.ms, "pan": scene.pan, "mspan": scene.pan,
             "quad": (scene.ms,) * 4}, w, ps, device,
            lambda m: log(f"train_conv: {m}"))
    except RuntimeError as e:
        check(False, f"train_conv: {e}")
    # The last row and column of anchors: windows reach the padded edge.
    edge = torch.from_numpy(np.concatenate([
        np.arange((h - 1) * w, n), np.arange(w - 1, n, w)]).astype(np.int32)
    ).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        ms, pan = scene.ms.to(dtype), scene.pan.to(dtype)
        before = gather_ops.gather_windows_cuda.launches
        got = gather_ops.gather_dual_fast(ms, pan, edge, w, ps)
        check(gather_ops.gather_windows_cuda.launches == before + 1,
              "train_conv: not one B1 launch at the edge anchors")
        for g, r in zip(got, gather_dual(ms, pan, edge, w, ps), strict=True):
            check(g.shape == r.shape and torch.equal(g, r),
                  f"train_conv: B1 != plain at patch 47, {dtype} edge "
                  f"anchors (max {_max_err(g, r)})")
        del ms, pan
    log("kernels: gather_dual patch 47 (MS rows of 188, PAN 188x188): "
        "bit-equal at the edge anchors, f32 and bf16")
    rng = np.random.default_rng(47)
    return {f"B{batch}": time_gather(scene, (scene.ms, scene.pan),
                                     DualPrograms.gathers, batch, rng)
            for batch in (BUCKET, TRAIN_BATCH)}


def _conv_crop_parity(scene, model, device):
    """On a CONV_CROP x CONV_CROP anchor crop at odd offsets (every one of
    the 16 phases), f32 with TF32 off: the map route's logits on the card
    against the window route's (windows gathered through B1 from the whole
    scene) and against the map route's on the CPU.  Returns the readings
    and the f32 copy of ``model`` on the card (TF32 stays off)."""
    from dmfusion_torch.models import gmfnet_conv
    ps, w = scene.patch, scene.width
    r0, c0 = (scene.height - CONV_CROP) // 2 | 1, (w - CONV_CROP) // 2 | 1
    ms = scene.ms[r0:r0 + CONV_CROP + ps - 1, c0:c0 + CONV_CROP + ps - 1]
    pan = scene.pan[4 * r0:4 * (r0 + CONV_CROP + ps - 1),
                    4 * c0:4 * (c0 + CONV_CROP + ps - 1)]
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    cfg32 = load_config(overrides={**CONV_CFG, "precision": {
        "compute_dtype": "float32", "scene_dtype": "float32"}})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m32 = build_model(cfg32)
    m32.load_state_dict(state)
    m32.eval()
    xs, ys = np.meshgrid(np.arange(CONV_CROP), np.arange(CONV_CROP),
                         indexing="ij")
    ids = torch.from_numpy(((xs + r0) * w + ys + c0).reshape(-1)
                           .astype(np.int32)).to(device)
    with torch.inference_mode():
        cpu_map = m32.logits_map(ms.cpu(), pan.cpu(), ps)
        m32 = m32.to(device, memory_format=torch.channels_last)
        card_map = m32.logits_map(ms, pan, ps)
        win = torch.cat([m32(*[t.float() for t in gather_ops.gather_dual_fast(
            scene.ms, scene.pan, b, w, ps)]) for b in ids.split(BUCKET)])
    win = win.reshape(CONV_CROP, CONV_CROP, -1)
    check(isinstance(m32, gmfnet_conv.Net)
          and card_map.shape == win.shape == cpu_map.shape,
          f"train_conv: crop shapes {tuple(card_map.shape)} "
          f"{tuple(win.shape)} {tuple(cpu_map.shape)}")
    gap_win = _max_err(card_map, win)
    gap_cpu = _max_err(card_map.cpu(), cpu_map)
    check(gap_win <= 1e-3 and gap_cpu <= 1e-3,
          f"train_conv: f32 map route vs window route {gap_win}, vs CPU "
          f"{gap_cpu} (> 1e-3)")
    return {"crop": [CONV_CROP, CONV_CROP], "offset": [r0, c0],
            "map_vs_window_max_abs": gap_win, "map_vs_cpu_max_abs": gap_cpu,
            "logit_scale": float(card_map.abs().max()),
            "tolerance": 1e-3}, m32


def phase_train_conv(device) -> tuple[int, dict]:
    """Train gmfnet_conv w64 at patch 47 on image6 through ``python -m
    dmfusion_torch.cli``'s ``main`` (2 epochs, test and color by the map
    route), check what it writes and computes, hold B1 at patch 47 and the
    two routes against each other, export the best weights with ``python
    -m dmfusion_torch.export --map`` and serve the artifact; returns B1's
    launches over the CLI run and its patch-47 times."""
    from dmfusion_torch import cli
    from dmfusion_torch import export as export_cli
    from dmfusion_torch.tools import convmap_ab
    from dmfusion_torch.train.steps import ConvMapPrograms
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_conv_")
    renders = []
    predict_map = ConvMapPrograms.predict_map

    def counted(self, *args, **kw):
        renders.append(1)
        return predict_map(self, *args, **kw)
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        ConvMapPrograms.predict_map = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver = cli.main(["--set", *CONV_TRAIN_SET,
                               f"expo_result={tmp}/"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            ConvMapPrograms.predict_map = predict_map
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        prog, model, scene = solver.programs, solver.model, solver.scene
        log(f"train_conv: the CLI run took {run_s:.2f} s; epochs "
            f"{rec['EpochTime']} s, losses {rec['Loss']}, val "
            f"{rec['ValLoss']}")
        check(isinstance(prog, ConvMapPrograms) and prog.supports_map
              and model.head1.in_features == 4 * 64
              and cfg["patch_size"] == 47 and cfg["batchsize"] == TRAIN_BATCH
              and model.compute_dtype == torch.bfloat16
              and scene.ms.dtype == torch.float32
              and solver.device.type == "cuda", "train_conv: not the w64, "
              "patch 47, bf16, f32-scene run on the card")
        check(rec["Epoch"] == [0, 1], f"train_conv: epochs {rec['Epoch']}")
        check(all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
              f"train_conv: non-finite losses {rec['Loss']} {rec['ValLoss']}")
        check(int(solver.test_matrix.sum()) == len(split.test),
              "train_conv: test matrix does not sum to the test split")
        aa, oa, kap, _ = solver.last_result
        check(oa >= 0.5, f"train_conv: test OA {oa} < 0.5")
        out = cfg["RESULT_output"]
        for f in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                  "0_records.json", "0_pic_1.png", "0_pic_2.png"):
            check(os.path.isfile(os.path.join(out, f)), f"train_conv: no {f}")
        check(os.path.isfile(cfg["RESULT_excel"]), "train_conv: no workbook")
        _keep_workbook(cfg, "train_conv", oa)
        # Test and color render one class map each and gather nothing; B1
        # runs once (MS and PAN) on every train and val batch.
        check(len(renders) == 2, f"train_conv: {len(renders)} map renders, "
              "not 2 (test, color)")
        ev = solver._eval_round_to()
        batches = {"train": -(-len(split.train) // TRAIN_BATCH) * 2,
                   "val": -(-len(split.valid) // ev) * 2}
        want = sum(batches.values())
        check(ev == EVAL_BATCH and launches["gather_windows"] == want,
              f"train_conv: {launches['gather_windows']} B1 launches, the "
              f"split sizes give {want} ({batches}, eval batches of {ev}) "
              "and none in test and color")

        ms, pan = solver.scene_args
        b1 = _b1_patch47(scene, device)

        # The val phase alone; 20 train steps, then a profile of them.
        vb = solver.batches(split.valid, cfg["color_batchsize"], round_to=ev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.eval_epoch(solver.scene_args, vb[0], vb[1],
                              vb[2].float())[0])
        val_s = time.perf_counter() - t0
        best = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        steps = (tb[0][:PROFILE_STEPS], tb[1][:PROFILE_STEPS],
                 tb[2][:PROFILE_STEPS].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.train_epoch(solver.scene_args, *steps).mean())
        train_steps_s = time.perf_counter() - t0
        prof = _profile(lambda: prog.train_epoch(solver.scene_args, *steps),
                        f"{PROFILE_STEPS} gmfnet_conv train steps, B "
                        f"{TRAIN_BATCH}, patch 47", 10)
        log("profile train_conv: " + json.dumps(prof))
        # Back to the best weights for the route checks and the export.
        model.load_state_dict(best)

        # The two routes with the best weights: f32 on a crop, bf16 over
        # 32,768 anchors of the scene (and the map's times), 3 bands.
        crop, m32 = _conv_crop_parity(scene, model, device)
        log(f"train_conv: crop parity {json.dumps(crop)}")
        ab = convmap_ab.run(device, cfg["data_city"],
                            model.head1.in_features // 4, cfg["patch_size"],
                            state=best,
                            scene=scene, anchors=CONV_AB_ANCHORS,
                            parity_anchors=CONV_AB_PARITY, batch=EVAL_BATCH,
                            warmup=2, repeats=10)
        log(f"train_conv: convmap_ab {json.dumps(ab)}")
        check(ab["agreement"] >= CONV_AGREE_MIN
              and ab["parity_anchors"] == CONV_AB_PARITY,
              f"train_conv: bf16 route agreement {ab['agreement']} over "
              f"{ab['parity_anchors']} anchors")
        map_prof = _profile(lambda: prog.predict_map(ms, pan, 0),
                            "one gmfnet_conv image6 map", 8)
        log("profile train_conv map: " + json.dumps(map_prof))
        map_ops = _op_profile(lambda: prog.predict_map(ms, pan, 0),
                              "one gmfnet_conv image6 map, by operator", 12)
        log("profile train_conv map ops: " + json.dumps(map_ops))
        # 3 bands against the whole map, in f32 (TF32 off) and in bf16.
        # cuDNN picks its conv kernels by shape, so a band's sums may run
        # in another order than the whole pass's: bit-equal in f32 is the
        # check, bf16 near-tie argmax flips are counted.
        bands = {}
        for tag, p in (("f32", ConvMapPrograms(m32, None, cfg, scene.width,
                                               scene.patch)), ("bf16", prog)):
            whole = p.predict_map(ms, pan, 0)
            bands[tag] = int((p.predict_map(ms, pan, 3) != whole).sum())
        del m32
        band_agree = 1 - bands["bf16"] / whole.numel()
        log(f"train_conv: 3 bands vs whole, pixels apart {json.dumps(bands)}"
            f" of {whole.numel()}")

        # Entry points 2 and 3: export --map, then serve the artifact.
        art = os.path.join(tmp, "conv_map.zip")
        export_cli.main(["--set", *CONV_TRAIN_SET, "--weights",
                         os.path.join(out, "0_weights.pt"), "--map", "--out",
                         art])
        clf = load_artifact(art, device)
        check(clf.is_map and clf.manifest["serving"] == "map"
              and clf.manifest["conv_bands"] == 0,
              f"train_conv: artifact manifest {clf.manifest}")
        served = ScenePredictor(clf, scene).class_map()
        check(np.array_equal(served, whole.cpu().numpy()),
              "train_conv: the served map != the solver's map")
        ev_res = ScenePredictor(clf, scene).evaluate()
        ev_res.pop("confusion")
        try:
            clf.predict(ms[None, :47, :47], pan[None, :188, :188, None])
            check(False, "train_conv: predict on a map artifact returned")
        except ValueError as e:
            check("whole scenes" in str(e), f"train_conv: predict: {e}")
        log(f"train_conv: served --map artifact: map equal, evaluate "
            f"{json.dumps(ev_res)}")
        check(prog.band_plan(ms.shape[0], 3) is not None
              and bands["f32"] == 0 and band_agree >= CONV_BAND_AGREE_MIN,
              f"train_conv: 3 bands vs the whole map: {bands} pixels apart "
              f"(f32 must be 0, bf16 agreement {band_agree} >= "
              f"{CONV_BAND_AGREE_MIN})")
        test_s, color_s = solver.test_time, solver.color_time
        n_train = len(split.train)
        del solver, prog, model, clf, whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    result = {
        "model": "gmfnet_conv", "width": 64, "patch": 47,
        "batch": TRAIN_BATCH, "run_s": run_s, "epoch_s": rec["EpochTime"],
        "loss": rec["Loss"], "val_loss": rec["ValLoss"],
        "val_oa": rec["ValOA"], "train_anchors": n_train,
        "val_anchors": len(split.valid), "test_anchors": len(split.test),
        "epoch1_samples_per_s": n_train / rec["EpochTime"][1],
        "train_steps": PROFILE_STEPS, "train_steps_s": train_steps_s,
        "train_step_ms": train_steps_s / PROFILE_STEPS * 1e3,
        "train_samples_per_s": PROFILE_STEPS * TRAIN_BATCH / train_steps_s,
        "busy_share": prof["busy_share"], "val_s": val_s, "test_s": test_s,
        "test_anchors_per_s": len(split.test) / test_s, "color_s": color_s,
        "test_oa": oa, "test_aa": aa, "test_kappa": kap,
        "gather_batches": batches, "launches": launches,
        "map_renders": len(renders), "b1_patch47": b1, "crop": crop,
        "map_ms": ab["map_ms"], "map_anchors_per_s": ab["map_anchors_per_s"],
        "map_peak_bytes": ab["map_peak_bytes"],
        "map_busy_share": map_prof["busy_share"],
        "bands3_pixels_apart": bands, "bands3_bf16_agreement": band_agree,
        "per_anchor_anchors_per_s": ab["per_anchor_anchors_per_s"],
        "speedup": ab["speedup"], "agreement": ab["agreement"],
        "served": ev_res}
    log(f"train_conv: {json.dumps(result)}")
    return launches["gather_windows"], b1


def phase_train_tri(scene, device, mspan) -> tuple[int, dict]:
    """Train tri_net w64 on image6 through ``python -m
    dmfusion_torch.cli``'s ``main`` (2 epochs, no test), check what it
    writes and computes, hold the gather route and the card's losses
    against their plain versions, export the best weights with ``python -m
    dmfusion_torch.export`` and serve them; time it, and the tri bucket on
    ``scene`` and ``mspan``; returns B1's launches over the CLI run and the
    tri bucket's times."""
    from dmfusion_torch import cli
    from dmfusion_torch import export as export_cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_tri_")
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = cli.main(["--set", *TRI_TRAIN_SET, f"expo_result={tmp}/"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        prog, model, sc = solver.programs, solver.model, solver.scene
        log(f"train_tri: the CLI run took {run_s:.2f} s; epochs "
            f"{rec['EpochTime']} s, losses {rec['Loss']}, val "
            f"{rec['ValLoss']}")
        check(isinstance(prog, TriPrograms)
              and model.ms_res.conv.out_channels == 64
              and cfg["patch_size"] == 16 and cfg["batchsize"] == TRAIN_BATCH
              and model.compute_dtype == torch.bfloat16
              and sc.ms.dtype == torch.float32
              and solver.device.type == "cuda", "train_tri: not the w64, "
              "patch 16, bf16, f32-scene run on the card")
        check(rec["Epoch"] == [0, 1], f"train_tri: epochs {rec['Epoch']}")
        check(all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
              f"train_tri: non-finite losses {rec['Loss']} {rec['ValLoss']}")
        check(rec["Loss"][1] < rec["Loss"][0],
              f"train_tri: epoch 1 loss {rec['Loss'][1]} not below epoch "
              f"0's {rec['Loss'][0]}")
        out = cfg["RESULT_output"]
        for f in ("0_weights.pt", "0_curweights.pt", "0_records.json"):
            check(os.path.isfile(os.path.join(out, f)), f"train_tri: no {f}")

        # MSPAN: PAN in exact arithmetic, padded like it.
        ms, pan, mp = solver.scene_args
        mspan_gap = float((mp - pan).abs().max())
        log(f"train_tri: MSPAN {tuple(mp.shape)} {mp.dtype}, max |MSPAN - "
            f"PAN| {mspan_gap}")
        check(mp.shape == pan.shape and mp.dtype == torch.float32
              and mspan_gap <= 1e-5, f"train_tri: MSPAN {tuple(mp.shape)} "
              f"{mp.dtype}, {mspan_gap} from the padded PAN")

        # B1: one launch (MS, PAN, MSPAN) per gathered batch.
        ev = solver._eval_round_to()
        batches = {"train": -(-len(split.train) // TRAIN_BATCH) * 2,
                   "val": -(-len(split.valid) // ev) * 2}
        want = sum(batches.values())
        check(ev == EVAL_BATCH and launches["gather_windows"] == want,
              f"train_tri: {launches['gather_windows']} B1 launches, the "
              f"split sizes give {want} ({batches}, eval batches of {ev})")

        # The gather route: val confusion through B1 and the plain gather.
        vb = solver.batches(split.valid, cfg["color_batchsize"], round_to=ev)
        vb = (vb[0], vb[1], vb[2].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, conf_k = prog.eval_epoch(solver.scene_args, *vb)
        conf_k = conf_k.cpu()
        val_s = time.perf_counter() - t0
        plain = TriPrograms(model, None, cfg, sc.width, sc.patch,
                            plain_gather=True)
        _, conf_p = plain.eval_epoch(solver.scene_args, *vb)
        check(torch.equal(conf_k, conf_p.cpu()),
              "train_tri: val confusion with B1 != with the plain gather")
        del plain

        # Train-only time of 20 steps, then a profile of the same steps.
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        steps = (tb[0][:PROFILE_STEPS], tb[1][:PROFILE_STEPS],
                 tb[2][:PROFILE_STEPS].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.train_epoch(solver.scene_args, *steps).mean())
        train_steps_s = time.perf_counter() - t0
        prof = _profile(lambda: prog.train_epoch(solver.scene_args, *steps),
                        f"{PROFILE_STEPS} tri_net train steps, B "
                        f"{TRAIN_BATCH}", 10)
        log("profile train_tri: " + json.dumps(prof))

        # Entry points 2 and 3: export the best weights, serve them.
        art = os.path.join(tmp, "tri.zip")
        weights = os.path.join(out, "0_weights.pt")
        export_cli.main(["--set", *TRI_TRAIN_SET, "--weights", weights,
                         "--out", art])
        clf = load_artifact(art, device)
        check(clf.manifest["arity"] == "tri"
              and len(clf.manifest["input_shapes"]) == 3
              and clf.manifest["seed"] == cfg["seed"],
              f"train_tri: artifact manifest {clf.manifest}")
        pred = ScenePredictor(clf, sc, bucket=BUCKET)
        check(torch.equal(pred.mspan, mp), "train_tri: the served MSPAN != "
              "the solver's")
        solver._use_eval_params()  # the best weights, as test and color

        rng = np.random.default_rng(10)
        chunks = rng.choice(split.labeled, (1 + TRI_REQUESTS) * BUCKET,
                            replace=False).astype(np.int32).reshape(
                                -1, BUCKET)
        pred.predict_ids(chunks[0])
        before = gather_ops.gather_windows_cuda.launches
        request_ms, served = [], []
        for c in chunks[1:]:
            t0 = time.perf_counter()
            served.append(pred.predict_ids(c))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        req_launches = gather_ops.gather_windows_cuda.launches - before
        check(req_launches == TRI_REQUESTS,
              f"train_tri: {req_launches} B1 launches for {TRI_REQUESTS} "
              "requests")
        check(np.array_equal(np.concatenate(served), solver._predict_ids(
            chunks[1:].reshape(-1), BUCKET)),
              "train_tri: served labels != the solver's per-anchor "
              "prediction (its color route)")
        # Where a request's (and a test batch's) time goes.
        req_prof = _profile(lambda: [pred.predict_ids(c)
                                     for c in chunks[1:3]],
                            "2 tri_net requests of 4096", 10)
        log("profile train_tri requests: " + json.dumps(req_prof))
        try:
            export_cli.main(["--set", *TRI_TRAIN_SET, "--weights", weights,
                             "--map", "--out", os.path.join(tmp, "m.zip")])
            check(False, "train_tri: export --map of tri_net returned")
        except ValueError as e:
            check("map route" in str(e), f"train_tri: export --map: {e}")
        log(f"train_tri: served the exported weights: {TRI_REQUESTS} "
            f"requests equal to the solver's, request ms {request_ms}")
        n_train, n_val = len(split.train), len(split.valid)
        del solver, prog, model, clf, pred, ms, pan, mp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # The MSPAN build on the card, the tri bucket, the losses' parity.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = mspan_scene(scene, CFG["seed"])
    torch.cuda.synchronize()
    mspan_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(built, mspan), "train_tri: MSPAN differs between "
          "two builds from one seed")
    del built
    # Its host share: the offsets drawn on a CPU generator.
    t0 = time.perf_counter()
    ihs.unpool_offsets((scene.height, scene.width, int(scene.ms.shape[-1])),
                       int(scene.ms.shape[-1]),
                       torch.Generator().manual_seed(CFG["seed"]))
    offsets_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(12)
    tri = {f"B{batch}": time_gather(scene, (scene.ms, scene.pan, mspan),
                                    TriPrograms.gathers, batch, rng)
           for batch in (BUCKET, TRAIN_BATCH)}
    parity = _parity_losses(scene, (scene.ms, scene.pan, mspan), device, rng)
    result = {
        "model": "tri_net", "width": 64, "patch": 16, "batch": TRAIN_BATCH,
        "run_s": run_s, "epoch_s": rec["EpochTime"], "loss": rec["Loss"],
        "val_loss": rec["ValLoss"], "val_oa": rec["ValOA"],
        "train_anchors": n_train, "val_anchors": n_val,
        "epoch1_samples_per_s": n_train / rec["EpochTime"][1],
        "train_steps": PROFILE_STEPS, "train_steps_s": train_steps_s,
        "train_step_ms": train_steps_s / PROFILE_STEPS * 1e3,
        "train_samples_per_s": PROFILE_STEPS * TRAIN_BATCH / train_steps_s,
        "busy_share": prof["busy_share"], "val_s": val_s,
        "mspan_gap_to_pan": mspan_gap, "mspan_build_ms": mspan_ms,
        "mspan_offsets_draw_ms": offsets_ms,
        "request_busy_share": req_prof["busy_share"],
        "gather_batches": batches, "launches": launches,
        "request_ms_median": statistics.median(request_ms),
        "request_ms": request_ms, "tri_bucket": tri, "parity": parity}
    log(f"train_tri: {json.dumps(result)}")
    return launches["gather_windows"], tri


def gan_scenes(scene) -> tuple[np.ndarray, np.ndarray]:
    """Seeded stand-ins of stage 1's output at the scene's shape, float32:
    msgan (the GAN's fake PAN) near pan2ms(PAN), pangan (its fake MS) near
    MS, each plus ``GAN_NOISE`` times a seeded normal draw."""
    size = (scene.height, scene.width, int(scene.raw_ms.shape[-1]))
    rng = np.random.default_rng(CFG["seed"])
    pms = ihs.pan2ms(torch.from_numpy(scene.raw_pan), size).numpy()
    msgan = pms + GAN_NOISE * rng.standard_normal(size, dtype=np.float32)
    pangan = scene.raw_ms + GAN_NOISE * rng.standard_normal(
        size, dtype=np.float32)
    return msgan.astype(np.float32), pangan.astype(np.float32)


def phase_train_quad(scene, device, quad, gan) -> int:
    """Stage 2 of the two-stage solver: dqtl w64 on image6 through ``python
    -m dmfusion_torch.cli --solver twostage``'s ``main`` (2 epochs, no test)
    on the seeded stage-1 scenes ``gan`` (written first); check what
    it writes and computes, hold the gather route and the card's losses
    against their plain versions, export the best weights with ``python -m
    dmfusion_torch.export`` and serve them with the GAN scenes; time it,
    and hold the card's losses on ``quad`` (the same four streams);
    returns B1's launches over the CLI run."""
    from dmfusion_torch import cli
    from dmfusion_torch import export as export_cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_quad_")
    try:
        gan_dir = os.path.join(tmp, "dqtl_weights")
        os.makedirs(gan_dir)
        for name, arr in zip(("msgan.npy", "pangan.npy"), gan):
            np.save(os.path.join(gan_dir, name), arr)
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = cli.main([*QUAD_TRAIN_SET, f"expo_result={tmp}/"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        prog, model, sc = solver.programs, solver.model, solver.scene
        log(f"train_quad: the CLI run took {run_s:.2f} s; epochs "
            f"{rec['EpochTime']} s, losses {rec['Loss']}, val "
            f"{rec['ValLoss']}, val OA {rec['ValOA']}")
        check(isinstance(prog, QuadPrograms)
              and model.blocks[0].conv.out_channels == 64
              and cfg["patch_size"] == 16 and cfg["batchsize"] == TRAIN_BATCH
              and model.compute_dtype == torch.bfloat16
              and all(t.dtype == torch.float32 and t.is_cuda
                      for t in solver.scene_args)
              and solver.device.type == "cuda", "train_quad: not the w64, "
              "patch 16, bf16, f32-stream run on the card")
        for got, want in zip(solver.scene_args, quad, strict=True):
            check(torch.equal(got, want), "train_quad: the solver's streams "
                  "differ from the ones built from the same GAN scenes")
        check(rec["Epoch"] == [0, 1], f"train_quad: epochs {rec['Epoch']}")
        check(all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
              f"train_quad: non-finite losses {rec['Loss']} {rec['ValLoss']}")
        check(rec["Loss"][1] < rec["Loss"][0],
              f"train_quad: epoch 1 loss {rec['Loss'][1]} not below epoch "
              f"0's {rec['Loss'][0]}")
        out = cfg["RESULT_output"]
        for f in ("0_weights.pt", "0_curweights.pt", "0_records.json"):
            check(os.path.isfile(os.path.join(out, f)), f"train_quad: no {f}")

        # B1: one launch (MS, pan2ms(PAN), msgan, pangan) per gathered
        # batch; the train batches are trimmed to whole ones.
        ev = solver._eval_round_to()
        batches = {"train": len(split.train) // TRAIN_BATCH * 2,
                   "val": -(-len(split.valid) // ev) * 2}
        want = sum(batches.values())
        check(ev == EVAL_BATCH and launches["gather_windows"] == want,
              f"train_quad: {launches['gather_windows']} B1 launches, the "
              f"split sizes give {want} ({batches}, eval batches of {ev})")

        # B1 at the train path's shape: a shuffled train batch and the
        # last one, padded with masked anchor 0, against the plain gather.
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        real_last = int(tb[2][-1].sum())
        check(0 < real_last < TRAIN_BATCH,
              f"train_quad: the last train batch holds {real_last} anchors")
        for tag, row in (("shuffled", 0), (f"last, {real_last} real", -1)):
            got = gather_ops.gather_quad_fast(*solver.scene_args, tb[0][row],
                                              sc.width, sc.patch)
            want_w = gather_quad(*solver.scene_args, tb[0][row], sc.width,
                                 sc.patch)
            for g, r in zip(got, want_w, strict=True):
                check(g.shape == r.shape and torch.equal(g, r),
                      f"train_quad: B1 != plain on the {tag} train batch "
                      f"(max {_max_err(g, r)})")
            log(f"kernels: gather_quad B={TRAIN_BATCH} {tag} train batch: "
                f"bit-equal 4 x {tuple(got[0].shape)}")

        # The gather route: the five val confusions through B1 and the
        # plain gather.
        vb = solver.batches(split.valid, cfg["color_batchsize"], round_to=ev)
        vb = (vb[0], vb[1], vb[2].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, conf_k = prog.eval_epoch(solver.scene_args, *vb)
        conf_k = conf_k.cpu()
        val_s = time.perf_counter() - t0
        plain = QuadPrograms(model, None, cfg, sc.width, sc.patch,
                             plain_gather=True)
        _, conf_p = plain.eval_epoch(solver.scene_args, *vb)
        check(conf_k.shape == (5, 12, 12) and torch.equal(conf_k,
                                                          conf_p.cpu()),
              "train_quad: val confusions with B1 != with the plain gather")
        del plain

        # Train-only time of 20 steps, then a profile of the same steps.
        steps = (tb[0][:PROFILE_STEPS], tb[1][:PROFILE_STEPS],
                 tb[2][:PROFILE_STEPS].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.train_epoch(solver.scene_args, *steps).mean())
        train_steps_s = time.perf_counter() - t0
        prof = _profile(lambda: prog.train_epoch(solver.scene_args, *steps),
                        f"{PROFILE_STEPS} dqtl train steps, B "
                        f"{TRAIN_BATCH}", 10)
        log("profile train_quad: " + json.dumps(prof))

        # Entry points 2 and 3: export the best weights, serve them with
        # the GAN scenes.
        art = os.path.join(tmp, "dqtl.zip")
        weights = os.path.join(out, "0_weights.pt")
        export_cli.main(["--set", "model_name=dqtl", *TRAIN_SET,
                         "--weights", weights, "--out", art])
        clf = load_artifact(art, device)
        check(clf.manifest["arity"] == "quad"
              and clf.manifest["input_shapes"] == [["4b", "16", "16", "4"]],
              f"train_quad: artifact manifest {clf.manifest}")
        pred = ScenePredictor(clf, scene, bucket=BUCKET, gan_dir=gan_dir)
        for got, want_s in zip(pred.streams, solver.scene_args, strict=True):
            check(torch.equal(got, want_s), "train_quad: the served streams "
                  "!= the solver's")
        solver._use_eval_params()  # the best weights, as test and color
        rng = np.random.default_rng(14)
        chunks = rng.choice(split.labeled, (1 + QUAD_REQUESTS) * BUCKET,
                            replace=False).astype(np.int32).reshape(
                                -1, BUCKET)
        pred.predict_ids(chunks[0])
        before = gather_ops.gather_windows_cuda.launches
        request_ms, served = [], []
        for c in chunks[1:]:
            t0 = time.perf_counter()
            served.append(pred.predict_ids(c))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        req_launches = gather_ops.gather_windows_cuda.launches - before
        check(req_launches == QUAD_REQUESTS,
              f"train_quad: {req_launches} B1 launches for {QUAD_REQUESTS} "
              "requests")
        check(np.array_equal(np.concatenate(served), solver._predict_ids(
            chunks[1:].reshape(-1), BUCKET)),
              "train_quad: served labels != the solver's per-anchor "
              "prediction (its color route)")
        # The same requests with the plain gather on the card.
        for c, p in zip(chunks[1:], served):
            ids = torch.from_numpy(c).to(device)
            win = gather_quad(*pred.streams, ids, sc.width, sc.patch)
            plain_p = clf.predict(torch.cat(win).float()).cpu().numpy()
            check(np.array_equal(plain_p, p), "train_quad: kernel-gather "
                  "and plain-gather predictions differ")
        req_prof = _profile(lambda: [pred.predict_ids(c)
                                     for c in chunks[1:3]],
                            "2 dqtl requests of 4096", 10)
        log("profile train_quad requests: " + json.dumps(req_prof))

        # The three serving refusals.
        refusals = (("no gan_dir", {}, ValueError, "--gan-weights"),
                    ("missing", {"gan_dir": tmp}, FileNotFoundError,
                     "msgan.npy"),
                    ("stale", {"gan_dir": os.path.join(tmp, "stale")},
                     ValueError, "pangan.npy has shape"))
        stale = refusals[2][1]["gan_dir"]
        os.makedirs(stale)
        np.save(os.path.join(stale, "msgan.npy"), gan[0])
        np.save(os.path.join(stale, "pangan.npy"), gan[1][:-1])
        for tag, kw, exc, words in refusals:
            try:
                ScenePredictor(clf, scene, bucket=BUCKET, **kw)
                check(False, f"train_quad: serving with {tag} GAN scenes "
                      "was not refused")
            except exc as e:
                check(words in str(e), f"train_quad: {tag}: {e}")
        log(f"train_quad: served the exported weights: {QUAD_REQUESTS} "
            f"requests equal to the solver's and to the plain gather's, "
            f"request ms {request_ms}; the three refusals raised")
        n_train, n_val = len(split.train), len(split.valid)
        del solver, prog, model, clf, pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    parity = _parity_losses(scene, quad, device,
                            np.random.default_rng(15))
    result = {
        "model": "dqtl", "width": 64, "patch": 16, "batch": TRAIN_BATCH,
        "run_s": run_s, "epoch_s": rec["EpochTime"], "loss": rec["Loss"],
        "val_loss": rec["ValLoss"], "val_oa": rec["ValOA"],
        "train_anchors": n_train, "val_anchors": n_val,
        "epoch1_samples_per_s": n_train / rec["EpochTime"][1],
        "train_steps": PROFILE_STEPS, "train_steps_s": train_steps_s,
        "train_step_ms": train_steps_s / PROFILE_STEPS * 1e3,
        "train_samples_per_s": PROFILE_STEPS * TRAIN_BATCH / train_steps_s,
        "busy_share": prof["busy_share"], "val_s": val_s,
        "request_busy_share": req_prof["busy_share"],
        "gather_batches": batches, "launches": launches,
        "request_ms_median": statistics.median(request_ms),
        "request_ms": request_ms, "parity": parity}
    log(f"train_quad: {json.dumps(result)}")
    return launches["gather_windows"]


def _gan_parity(tiles_m, tiles_p, device) -> dict:
    """Three ``GanPrograms`` steps at the full width (gan_width 32) from
    the same seeded weights and the same noise (drawn on the CPU), on
    ``GAN_PARITY_BATCH`` stage-1 tiles a step cropped to
    ``GAN_PARITY_PIC``: f32 on the CPU and on the card (TF32 off), bf16 on
    the card; the d and g losses of each step."""
    pic, bs = GAN_PARITY_PIC, GAN_PARITY_BATCH
    m = tiles_m[:PARITY_STEPS * bs, :pic, :pic].reshape(
        PARITY_STEPS, bs, pic, pic, -1).cpu()
    p = tiles_p[:PARITY_STEPS * bs, :pic, :pic].reshape(m.shape).cpu()
    gen = torch.Generator().manual_seed(CFG["seed"])
    noise = [(torch.randn(m.shape[1:], generator=gen),
              torch.randn(p.shape[1:], generator=gen))
             for _ in range(PARITY_STEPS)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tag, dev, dtype in (("f32_cpu", torch.device("cpu"), "float32"),
                            ("f32_card", device, "float32"),
                            ("bf16_card", device, "bfloat16")):
        cfg = load_config(overrides={**CFG, "gan_width": GAN_WIDTH,
                                     "device": "cpu", "precision": {
                                         "compute_dtype": dtype}})
        nets = [build_model(cfg, n).to(dev) for n in (
            "generator", "generator", "discriminator", "discriminator")]
        if dev.type == "cuda":
            nets = [n.to(memory_format=torch.channels_last) for n in nets]
        prog = GanPrograms(*nets, cfg)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        losses = []
        for i in range(PARITY_STEPS):
            r = prog.step(m[i].to(dev), p[i].to(dev),
                          *(n.to(dev) for n in noise[i]))
            losses.append(torch.stack([r["d_loss"], r["g_loss"]]))
        out[tag] = torch.stack(losses).cpu()
    for t in out.values():
        check(bool(torch.isfinite(t).all()), "train_gan parity: non-finite "
              "loss")
    gap32 = float((out["f32_card"] - out["f32_cpu"]).abs().max())
    gap16 = float(((out["bf16_card"] - out["f32_card"]).abs()
                   / out["f32_card"].abs()).max())
    check(gap32 <= 1e-3, f"train_gan: f32 card vs CPU GAN losses differ by "
          f"{gap32}")
    check(gap16 <= GAN_BF16_RTOL, f"train_gan: bf16 vs f32 GAN losses differ "
          f"by {gap16} relative > {GAN_BF16_RTOL}")
    return {"gan_width": GAN_WIDTH, "pic": pic, "batch": bs,
            "steps": PARITY_STEPS,
            "losses_d_g": {k: v.tolist() for k, v in out.items()},
            "f32_card_vs_cpu_max_abs": gap32, "f32_tolerance": 1e-3,
            "bf16_vs_f32_card_max_rel": gap16,
            "bf16_tolerance_rel": GAN_BF16_RTOL}


def phase_train_gan(scene, device) -> int:
    """Stage 1 and stage 2 of the two-stage solver through ``python -m
    dmfusion_torch.cli --solver twostage``'s ``main`` with
    ``dqtl.pre_trained=0``: the GAN quartet at the config's sizes writes
    msgan/pangan, and dqtl trains and tests on them; check what stage 1
    writes and computes, the GAN steps on the card against the CPU, the
    checkpoints' round trip, B1 on the stage-1 streams, and serving with
    stage 1's own scenes; time it.  Returns B1's launches over the CLI
    run."""
    from dmfusion_torch import cli
    from dmfusion_torch import export as export_cli
    from dmfusion_torch.report.excel import Workbook
    from dmfusion_torch.solvers import TwoStageSolver
    from dmfusion_torch.train.checkpoint import load_checkpoint
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_gan_")
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = cli.main([*GAN_TRAIN_SET, f"expo_result={tmp}/"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        d, s1 = cfg["dqtl"], solver.stage1_log
        gans = solver.gan_programs
        log(f"train_gan: the CLI run took {run_s:.2f} s; stage 1 tiles "
            f"{s1['tiles_s']:.3f} s, epochs {s1['epoch_s']} s, sample grids "
            f"{s1['samples_s']:.3f} s, scenes and renders "
            f"{s1['scenes_s']:.3f} s; stage 2 epochs {rec['EpochTime']} s, "
            f"losses {rec['Loss']}, val OA {rec['ValOA']}")

        # Stage 1 at the config's sizes.
        check(isinstance(solver, TwoStageSolver)
              and isinstance(solver.programs, QuadPrograms)
              and gans.nets["gP"].enc1.conv.out_channels == GAN_WIDTH
              and gans.nets["dP"].blocks[0].conv.out_channels == GAN_WIDTH
              and (d["pic_size"], d["batch_size"], d["epochs"], d["lr"])
              == (GAN_PIC, GAN_BATCH, GAN_EPOCHS, 1e-4)
              and not d["pre_trained"]
              and all(p.is_cuda for p in gans._g_params)
              and gans.nets["gP"].compute_dtype == torch.bfloat16,
              f"train_gan: not stage 1 at gan_width 32, pic 128, batch 4, "
              f"{GAN_EPOCHS} epochs, bf16, on the card")
        check(len(s1["epoch_s"]) == GAN_EPOCHS
              and all(len(x) == GAN_STEPS for x in s1["d_loss"])
              and bool(np.isfinite(s1["d_loss"] + s1["g_loss"]).all()),
              f"train_gan: stage 1 ran {len(s1['epoch_s'])} epochs of "
              f"{[len(x) for x in s1['d_loss']]} steps, or a loss is "
              "not finite")
        wdir = solver._weights_dir()
        size = (scene.height, scene.width, 4)
        scenes = {}
        for name in ("msgan.npy", "pangan.npy"):
            arr = np.load(os.path.join(wdir, name))
            check(arr.shape == size and arr.dtype == np.float32
                  and bool(np.isfinite(arr).all())
                  and 0 <= arr.min() and arr.max() <= 1,
                  f"train_gan: {name} {arr.shape} {arr.dtype}, range "
                  f"[{arr.min()}, {arr.max()}]")
            scenes[name] = arr
        check(np.array_equal(scenes["msgan.npy"], solver.ms_gan)
              and np.array_equal(scenes["pangan.npy"], solver.pan_gan),
              "train_gan: the written GAN scenes are not the solver's")
        files = [d[k] for k in ("check_gH", "check_gZ", "check_dH",
                                "check_dZ")]
        files += ["fake_ms.png", "fake_pan.png"] + [
            os.path.join("saved_images", f) for f in (
                "f_p_0.png", "f_m_0.png", "p.png", "m.png")]
        for f in files:
            check(os.path.isfile(os.path.join(wdir, f)), f"train_gan: no {f}")

        # Stage 2 on the stage-1 scenes: the streams, the test, B1's count.
        for got, want in zip(solver.scene_args, quad_streams(
                scene, solver.ms_gan, solver.pan_gan, device), strict=True):
            check(torch.equal(got, want), "train_gan: stage 2's streams are "
                  "not built from stage 1's scenes")
        check(rec["Epoch"] == [0, 1] and all(np.isfinite(rec["Loss"])),
              f"train_gan: stage 2 epochs {rec['Epoch']}, losses "
              f"{rec['Loss']}")
        n_test = len(split.test)
        check(int(solver.test_matrix.sum()) == n_test
              and all(int(m.sum()) == n_test
                      for m in solver.stream_matrices),
              "train_gan: a test matrix does not sum to the test split")
        aa, oa, kap, _ = solver.last_result
        stream_oa = [r[1] for r in solver.stream_results]
        # The fused and the MS stream's OA at least 0.5, as every training
        # cell's (train_quad and train_dp_streams' two-stage run do not
        # test), and the streams sheet.
        check(oa >= 0.5 and stream_oa[0] >= 0.5, f"train_gan: fused test "
              f"OA {oa} or the MS stream's {stream_oa[0]} < 0.5")
        sheet = Workbook.load(cfg["RESULT_excel"])["streams"]
        check([sheet.cell(2 + i, 1) for i in range(4)]
              == ["MS", "PAN", "GM", "GP"], "train_gan: no streams sheet")
        _keep_workbook(cfg, "train_gan", oa)
        ev = solver._eval_round_to()
        batches = {"train": len(split.train) // TRAIN_BATCH * 2,
                   "val": -(-len(split.valid) // ev) * 2,
                   "test": -(-n_test // ev)}
        want = sum(batches.values())
        check(ev == EVAL_BATCH and launches["gather_windows"] == want,
              f"train_gan: {launches['gather_windows']} B1 launches, the "
              f"split sizes give {want} ({batches}, eval batches of {ev})")
        check(launches["phase_pool"] == launches["strip_gather"]
              == launches["conv3x3"] == 0, f"train_gan: launches {launches}")
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        eb = solver.batches(split.test, EVAL_BATCH)
        for tag, ids in ((f"B {TRAIN_BATCH} train", tb[0][0]),
                         (f"B {EVAL_BATCH} test", eb[0][0])):
            got = gather_ops.gather_quad_fast(*solver.scene_args, ids,
                                              scene.width, scene.patch)
            want_w = gather_quad(*solver.scene_args, ids, scene.width,
                                 scene.patch)
            for g, r in zip(got, want_w, strict=True):
                check(g.shape == r.shape and torch.equal(g, r),
                      f"train_gan: B1 != plain on the stage-1 streams, {tag} "
                      f"batch (max {_max_err(g, r)})")
        log(f"train_gan: B1 bit-equal to the plain gather on the stage-1 "
            f"streams at a B {TRAIN_BATCH} train and a B {EVAL_BATCH} test "
            f"batch; {launches['gather_windows']} launches, one a batch: "
            f"{batches}")

        # The checkpoints' round trip: a fresh solver loads the four files.
        fresh = TwoStageSolver(dict(cfg, dqtl=dict(d, load_model=1)))
        fresh.init_stage1_model()
        for which, net in gans.nets.items():
            saved = load_checkpoint(solver._gan_ckpt(which), None,
                                    strict=True)
            for name, state in (("saved", net.state_dict()),
                                ("loaded", fresh.gan_programs.nets[
                                    which].state_dict())):
                check(saved.keys() == state.keys() and all(
                    torch.equal(saved[k], state[k].cpu()) for k in saved),
                    f"train_gan: {which}'s {name} state != its file")
        n = torch.randn((GAN_BATCH, GAN_PIC, GAN_PIC, 4),
                        generator=torch.Generator().manual_seed(5)).to(device)
        with torch.no_grad():
            for which in ("gP", "gM"):
                check(torch.equal(gans.nets[which](n),
                                  fresh.gan_programs.nets[which](n)),
                      f"train_gan: the reloaded {which}'s fakes differ")
        del fresh

        # 20 more stage-1 steps: time, busy share, operators.
        ms_tiles, pan_tiles, _, _ = solver._stage1_tiles()
        k = GAN_PROFILE_STEPS * GAN_BATCH
        m_b = torch.from_numpy(ms_tiles[:k]).to(device).reshape(
            GAN_PROFILE_STEPS, GAN_BATCH, GAN_PIC, GAN_PIC, 4)
        p_b = torch.from_numpy(pan_tiles[:k]).to(device).reshape(m_b.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(gans.train_epoch(m_b, p_b, "none")["g_loss"].sum())
        gan_steps_s = time.perf_counter() - t0
        gan_prof = _profile(lambda: gans.train_epoch(m_b, p_b, "none"),
                            f"{GAN_PROFILE_STEPS} GAN steps, batch "
                            f"{GAN_BATCH}, pic {GAN_PIC}, w{GAN_WIDTH}", 10)
        log("profile train_gan steps: " + json.dumps(gan_prof))
        gan_ops = _op_profile(lambda: gans.train_epoch(m_b[:5], p_b[:5],
                                                       "none"),
                              f"5 GAN steps, batch {GAN_BATCH}", 10)
        log("profile train_gan operators: " + json.dumps(gan_ops))
        parity = _gan_parity(m_b.flatten(0, 1), p_b.flatten(0, 1), device)
        log(f"train_gan: GAN step parity {json.dumps(parity)}")
        del m_b, p_b

        # Serving: the exported best weights with stage 1's own scenes.
        art = os.path.join(tmp, "dqtl.zip")
        export_cli.main(["--set", "model_name=dqtl", *TRAIN_SET, "--weights",
                         os.path.join(cfg["RESULT_output"], "0_weights.pt"),
                         "--out", art])
        clf = load_artifact(art, device)
        pred = ScenePredictor(clf, scene, bucket=BUCKET, gan_dir=wdir)
        for got, want_s in zip(pred.streams, solver.scene_args, strict=True):
            check(torch.equal(got, want_s), "train_gan: the served streams "
                  "!= the solver's")
        rng = np.random.default_rng(16)
        chunks = rng.choice(split.labeled, GAN_REQUESTS * BUCKET,
                            replace=False).astype(np.int32)
        before = gather_ops.gather_windows_cuda.launches
        t0 = time.perf_counter()
        served = pred.predict_ids(chunks)
        request_ms = (time.perf_counter() - t0) * 1e3 / GAN_REQUESTS
        check(gather_ops.gather_windows_cuda.launches - before
              == GAN_REQUESTS, "train_gan: not one B1 launch a request")
        check(np.array_equal(served, solver._predict_ids(chunks, BUCKET)),
              "train_gan: served predictions != the solver's")
        log(f"train_gan: served {GAN_REQUESTS} requests of {BUCKET} with "
            "stage 1's scenes, equal to the solver's predictions")
        test_s = solver.test_time
        result = {
            "gan_width": GAN_WIDTH, "pic": GAN_PIC, "batch": GAN_BATCH,
            "stage1_epochs": GAN_EPOCHS, "stage1_steps_an_epoch": GAN_STEPS,
            "run_s": run_s, "stage1_tiles_s": s1["tiles_s"],
            "stage1_samples_s": s1["samples_s"],
            "stage1_scenes_s": s1["scenes_s"],
            "stage1_epoch_s": s1["epoch_s"],
            "stage1_epoch0_s": s1["epoch_s"][0],
            "stage1_epoch1_on_mean_s": statistics.mean(s1["epoch_s"][1:]),
            "stage1_last_d_g": [s1["d_loss"][-1][-1], s1["g_loss"][-1][-1]],
            "gan_steps": GAN_PROFILE_STEPS, "gan_steps_s": gan_steps_s,
            "gan_step_ms": gan_steps_s / GAN_PROFILE_STEPS * 1e3,
            "gan_tiles_per_s": k / gan_steps_s,
            "gan_busy_share": gan_prof["busy_share"],
            "stage2_epoch_s": rec["EpochTime"], "stage2_loss": rec["Loss"],
            "val_oa": rec["ValOA"], "test_s": test_s,
            "test_anchors_per_s": n_test / test_s,
            "test_oa": oa, "test_aa": aa, "test_kappa": kap,
            "stream_oa_ms_pan_gm_gp": stream_oa,
            "gather_batches": batches, "launches": launches,
            "request_ms": request_ms, "parity": parity}
        # The two-stage solver and its run dir stay for the diagnostics
        # phase's four-stream visualize.
        KEPT["train_gan"] = (solver, tmp)
        del gans, clf, pred
    finally:
        _release(tmp)
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"train_gan: {json.dumps(result)}")
    return launches["gather_windows"]


def phase_zoo(scene, device) -> int:
    """The dual zoo models (``ZOO``) at the config's widths, bf16, from
    seeded weights: 20 train steps through ``DualPrograms``, then an
    artifact round trip serving 8 requests; logits against f32 on the card
    and the CPU; returns B1's launches over the steps and requests."""
    from dmfusion_torch.train.optim import make_optimizer
    from dmfusion_torch.train.steps import DualPrograms
    labeled, _ = split_labels(scene.label)
    rng = np.random.default_rng(13)
    picked = rng.choice(labeled, (ZOO_STEPS + 1) * TRAIN_BATCH,
                        replace=False).astype(np.int32)
    ids, mask, _ = batched_ids(picked, TRAIN_BATCH, device=device)
    labels = torch.from_numpy(scene.label.reshape(-1)[picked].astype(
        np.int64)).to(device).reshape(ids.shape)
    mask = mask.float()
    chunks = rng.choice(labeled, (1 + ZOO_REQUESTS) * BUCKET,
                        replace=False).astype(np.int32).reshape(-1, BUCKET)
    scene_args = (scene.ms, scene.pan)
    counter = gather_ops.gather_windows_cuda
    total, results = 0, {}
    for name, extra in ZOO.items():
        cfg = load_config(overrides={**CFG, "model_name": name, **extra})
        torch.cuda.reset_peak_memory_stats(device)
        model = build_model(cfg).to(device, memory_format=torch.channels_last)
        prog = DualPrograms(model, make_optimizer(cfg, model.parameters(),
                                                  ZOO_STEPS + 1),
                            cfg, scene.width, scene.patch)
        prog.init(torch.Generator().manual_seed(cfg["seed"]))
        counter.launches = 0
        # One warm-up step (cuDNN and cuBLAS pick their kernels), then 20.
        prog.train_epoch(scene_args, ids[:1], labels[:1], mask[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = prog.train_epoch(scene_args, ids[1:], labels[1:], mask[1:])
        losses = losses.cpu()
        step_ms = (time.perf_counter() - t0) / ZOO_STEPS * 1e3
        check(bool(torch.isfinite(losses).all())
              and float(losses[-5:].mean()) < float(losses[:5].mean()),
              f"zoo {name}: losses {losses.tolist()}")

        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/{name}.zip"
            save_artifact(path, cfg, model)
            clf = load_artifact(path, device)
        # The widths the loader read from the artifact's tree.
        for key, value in (extra or {"trans": cfg["trans"]}).items():
            got = clf.cfg[key]
            if isinstance(value, dict):
                got = {k: got[k] for k in value}
            check(got == value, f"zoo {name}: artifact {key} {got} != "
                  f"{value}")
        pred = ScenePredictor(clf, scene, bucket=BUCKET)
        pred.predict_ids(chunks[0])
        request_ms, served = [], []
        for c in chunks[1:]:
            t0 = time.perf_counter()
            served.append(pred.predict_ids(c))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches = counter.launches
        want = 1 + ZOO_STEPS + 1 + ZOO_REQUESTS  # one a gathered batch
        check(launches == want, f"zoo {name}: {launches} B1 launches, the "
              f"steps and requests give {want}")
        total += launches

        # The trained weights: bf16 on the card and f32 on the card (TF32
        # off) against f32 on the CPU on 256 anchors; bf16 vs f32 argmax
        # agreement over a request.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg32 = load_config(overrides={**cfg, "precision": {
            "compute_dtype": "float32", "scene_dtype": "float32"}})
        state = clf.model.state_dict()
        card32 = build_model(cfg32).to(device,
                                       memory_format=torch.channels_last)
        card32.load_state_dict(state)
        cpu32 = build_model(cfg32)
        cpu32.load_state_dict({k: v.cpu() for k, v in state.items()})
        req = torch.from_numpy(chunks[1]).to(device)
        ms_b, pan_b = gather_ops.gather_dual_fast(scene.ms, scene.pan, req,
                                                  scene.width, scene.patch)
        with torch.inference_mode():
            on_card = card32.eval()(ms_b, pan_b)
            served16 = clf.logits(ms_b, pan_b)
            on_cpu = cpu32.eval()(ms_b[:256].cpu(), pan_b[:256].cpu())
        check(np.array_equal(served16.argmax(-1).cpu().numpy(), served[0]),
              f"zoo {name}: served labels != the logits' argmax")
        for t in (on_card, served16):
            check(bool(torch.isfinite(t).all()) and t.dtype == torch.float32,
                  f"zoo {name}: logits dtype or non-finite values")
        err32 = _max_err(on_card[:256].cpu(), on_cpu)
        err16 = _max_err(served16[:256].cpu(), on_cpu)
        agree = float((served16.argmax(-1) == on_card.argmax(-1)).float()
                      .mean())
        agree_cpu = float((served16[:256].argmax(-1).cpu()
                           == on_cpu.argmax(-1)).float().mean())
        check(err32 <= 1e-3, f"zoo {name}: f32 card vs CPU logits differ by "
              f"{err32}")
        check(err16 <= ZOO_BF16_ATOL, f"zoo {name}: bf16 card vs f32 CPU "
              f"logits differ by {err16} > {ZOO_BF16_ATOL}")
        agree_min = ZOO_AGREE_MIN_BY.get(name, ZOO_AGREE_MIN)
        check(agree >= agree_min, f"zoo {name}: bf16 vs f32 argmax "
              f"agreement {agree} < {agree_min}")
        results[name] = {
            "params": sum(p.numel() for p in model.parameters()),
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "step_ms": step_ms,
            "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
            "request_ms_median": statistics.median(request_ms),
            "anchors_per_s": ZOO_REQUESTS * BUCKET / sum(request_ms) * 1e3,
            "request_ms": request_ms, "launches": launches,
            "f32_card_vs_cpu_max_abs": err32,
            "bf16_card_vs_f32_cpu_max_abs": err16,
            "bf16_vs_f32_card_argmax_agree_4096": agree,
            "bf16_card_vs_f32_cpu_argmax_agree_256": agree_cpu,
            "logit_scale": float(on_cpu.abs().max()),
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        log(f"zoo {name}: {json.dumps(results[name])}")
        del model, prog, clf, pred, card32, cpu32, on_card, served16
        torch.cuda.empty_cache()
    return total


def _ct_card_vs_cpu(scene, ids) -> dict:
    """The contourlet transform of one request batch's MS and PAN windows
    (f32) on the card against the CPU: within 1e-5 with TF32 off; the gap
    with TF32 on is recorded, and each pass timed."""
    from dmfusion_torch.ops.contourlet import contourlet_decompose
    ms_b, pan_b = gather_ops.gather_dual_fast(
        scene.ms, scene.pan, torch.from_numpy(ids).to(scene.ms.device),
        scene.width, scene.patch)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    out: dict = {"anchors": len(ids)}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            errs, secs = [], []
            for x in (ms_b, pan_b):
                x = x.permute(0, 3, 1, 2)
                want = contourlet_decompose(x.cpu())
                contourlet_decompose(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = contourlet_decompose(x)
                torch.cuda.synchronize()
                secs.append((time.perf_counter() - t0) * 1e3)
                errs += [_max_err(g.cpu(), w) for g, w in zip(got, want)]
            out["tf32" if tf32 else "f32"] = {
                "max_abs_err_low_sub_ms_pan": errs,
                "ms_ms_pan": secs}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    err = max(out["f32"]["max_abs_err_low_sub_ms_pan"])
    check(err <= 1e-5, f"train_ct: contourlet card vs CPU (TF32 off) "
          f"{err} > 1e-5")
    return out


def phase_train_ct(device) -> int:
    """Train ct_lstm w64 on image6 through ``python -m
    dmfusion_torch.cli``'s ``main`` (2 epochs, the proof grids), check
    what it writes and computes, time 20 more steps and profile them, and
    hold the contourlet transform on the card against the CPU; returns B1's
    launches over the CLI run."""
    from dmfusion_torch import cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_ct_")
    torch.cuda.reset_peak_memory_stats(device)
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = cli.main(["--set", *CT_TRAIN_SET, f"expo_result={tmp}/"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: spec["counter"].launches
                    for n, spec in KERNELS.items()}
        cfg, split, rec = solver.cfg, solver.split, solver.records
        prog, model, sc = solver.programs, solver.model, solver.scene
        log(f"train_ct: the CLI run took {run_s:.2f} s; epochs "
            f"{rec['EpochTime']} s, losses {rec['Loss']}, val "
            f"{rec['ValLoss']}")
        check(type(prog) is DualPrograms and model.lstm.features == 64
              and cfg["model_name"] == "ct_lstm"
              and cfg["patch_size"] == 16 and cfg["batchsize"] == TRAIN_BATCH
              and model.compute_dtype == torch.bfloat16
              and sc.ms.dtype == torch.float32
              and solver.device.type == "cuda", "train_ct: not the w64, "
              "patch 16, bf16, f32-scene ct_lstm run on the card")
        check(rec["Epoch"] == [0, 1], f"train_ct: epochs {rec['Epoch']}")
        check(all(np.isfinite(rec["Loss"] + rec["ValLoss"])),
              f"train_ct: non-finite losses {rec['Loss']} {rec['ValLoss']}")
        oa = rec["ValOA"][-1]
        check(oa >= CT_OA_MIN, f"train_ct: val OA {oa} < {CT_OA_MIN}")
        out = cfg["RESULT_output"]
        proof = [f"0_ct_{t}_{b}.png" for t in ("ms", "pan")
                 for b in ("low", "dfb")]
        for f in ("0_weights.pt", "0_curweights.pt", "0_records.json",
                  *proof):
            check(os.path.isfile(os.path.join(out, f)), f"train_ct: no {f}")

        # B1: one launch (MS, PAN) per gathered batch; test and color
        # are off and proof gathers its few windows with the plain gather.
        ev = solver._eval_round_to()
        batches = {"train": -(-len(split.train) // TRAIN_BATCH) * 2,
                   "val": -(-len(split.valid) // ev) * 2}
        want = sum(batches.values())
        check(ev == EVAL_BATCH and launches["gather_windows"] == want,
              f"train_ct: {launches['gather_windows']} B1 launches, the "
              f"split sizes give {want} ({batches}, eval batches of {ev})")

        # Train-only time of 20 steps, then a profile of the same steps.
        tb = solver.batches(split.train, TRAIN_BATCH, shuffle=True)
        steps = (tb[0][:PROFILE_STEPS], tb[1][:PROFILE_STEPS],
                 tb[2][:PROFILE_STEPS].float())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(prog.train_epoch(solver.scene_args, *steps).mean())
        train_steps_s = time.perf_counter() - t0
        prof = _profile(lambda: prog.train_epoch(solver.scene_args, *steps),
                        f"{PROFILE_STEPS} ct_lstm train steps, B "
                        f"{TRAIN_BATCH}", 10)
        log("profile train_ct: " + json.dumps(prof))
        rng = np.random.default_rng(14)
        ct_check = _ct_card_vs_cpu(sc, rng.choice(
            split.test, BUCKET, replace=False).astype(np.int32))
        log(f"train_ct: contourlet card vs CPU {json.dumps(ct_check)}")
        n_train, n_val = len(split.train), len(split.valid)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        del solver, prog, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    result = {
        "model": "ct_lstm", "width": 64, "patch": 16, "batch": TRAIN_BATCH,
        "run_s": run_s, "epoch_s": rec["EpochTime"], "loss": rec["Loss"],
        "val_loss": rec["ValLoss"], "val_oa": rec["ValOA"],
        "train_anchors": n_train, "val_anchors": n_val,
        "epoch1_samples_per_s": n_train / rec["EpochTime"][1],
        "train_steps": PROFILE_STEPS, "train_steps_s": train_steps_s,
        "train_step_ms": train_steps_s / PROFILE_STEPS * 1e3,
        "train_samples_per_s": PROFILE_STEPS * TRAIN_BATCH / train_steps_s,
        "busy_share": prof["busy_share"], "peak_mem_gb": peak_gb,
        "gather_batches": batches, "launches": launches,
        "contourlet": ct_check, "proof_pngs": proof}
    log(f"train_ct: {json.dumps(result)}")
    return launches["gather_windows"]


def phase_strip(scene, device) -> tuple[int, dict]:
    """B3: bit-equality with the plain version, the strip bench on the
    card, timings; returns the bench's launches and the kernel's row."""
    ps, w = scene.patch, scene.width
    c = int(scene.ms.shape[-1])
    xs_np, y0s_np = strip_gather_bench.strip_grid(scene.height, w, ps,
                                                  STRIP_ANCHORS, STRIP)
    xs = torch.from_numpy(xs_np).to(device)
    y0s = torch.from_numpy(y0s_np).to(device)
    # Edge strips (MS starts; PAN at 4x): past the bottom, past the right
    # edge, wholly below the view, and one at the origin; odd columns.
    hv, wv = int(scene.ms.shape[0]), int(scene.ms.shape[1])
    ex = torch.tensor([hv - 5, 3, hv + 2, 0], dtype=torch.int32,
                      device=device)
    ey = torch.tensor([wv - 61, wv - 7, 5, 1], dtype=torch.int32,
                      device=device)
    ms16, pan16 = scene.ms.bfloat16(), scene.pan.bfloat16()
    cases = [("f32 bench", scene.ms, scene.pan, xs, y0s),
             ("bf16 bench", ms16, pan16, xs, y0s),
             ("f32 edge", scene.ms, scene.pan, ex, ey),
             ("bf16 edge", ms16, pan16, ex, ey)]
    counter = strip_ops.gather_strips_cuda
    worst = 0.0
    for tag, ms, pan, sx, sy in cases:
        before = counter.launches
        got = strip_ops.gather_dual_strips(ms, pan, sx, sy, w, ps, STRIP)
        check(counter.launches == before + 2,
              f"strip {tag}: {counter.launches - before} launches, not 2")
        want = strip_ops.gather_dual_strips_ref(ms, pan, sx, sy, w, ps, STRIP)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            worst = max(worst, _max_err(g, r))
            check(g.dtype == ms.dtype and g.shape == r.shape
                  and torch.equal(g, r), f"strip {tag}: kernel != plain")
        if "edge" in tag:
            check(not got[0][2 * STRIP:3 * STRIP].any()
                  and not got[1][2 * STRIP:3 * STRIP].any(),
                  "strip below the view: windows not all zero")
        log(f"kernels: strip_gather {tag}: bit-equal, {sx.shape[0]} strips "
            f"-> ms {tuple(got[0].shape)} pan {tuple(got[1].shape)}")
        del got, want
    del ms16, pan16

    # The main path: the strip bench on the card.
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    bench = strip_gather_bench.run(device, STRIP_ANCHORS, STRIP, ps)
    launches = counter.launches
    check(launches == 2 * bench["strip_calls"],
          f"strip bench: {launches} launches for {bench['strip_calls']} "
          f"dual strip calls")
    log(f"strip bench: {json.dumps(bench)}")

    # Timing: the kernel on precomputed int32 starts (its wrapper reads
    # them back once per launch for the negative-start check), the plain
    # version whole, and one indexing call per view on precomputed grids.
    views = ((scene.ms.reshape(hv, -1), xs, y0s, ps, wv, 1, c),
             (scene.pan, 4 * xs, 4 * y0s, 4 * ps, scene.pan.shape[1], 4, 1))
    grids = [strip_ops.strip_grids(v, sx, sy, p, ch, STRIP, st)
             for v, sx, sy, p, _, st, ch in views]
    runs = {
        "plain": lambda i: strip_ops.gather_dual_strips_ref(
            scene.ms, scene.pan, xs, y0s, w, ps, STRIP),
        "kernel": lambda i: [strip_ops.gather_strips_cuda(v, sx, sy, p, vw,
                                                          STRIP, st)
                             for v, sx, sy, p, vw, st, _ in views],
        "library": lambda i: [pv[r, k] for pv, r, k in grids],
    }
    med, times = time_in_turns(runs, iters=10)
    moved = strip_gather_bench.moved_bytes(scene.ms, scene.pan, xs, y0s, ps,
                                           STRIP)
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"kernels: strip_gather {STRIP_ANCHORS} anchors f32 ms median of 6: "
        f"kernel {med['kernel']:.4f} plain {med['plain']:.4f} library "
        f"{med['library']:.4f} bound {bound:.4f} ({moved / 1e6:.1f} MB); "
        f"all: {json.dumps(times)}")
    return launches, {"max_abs_err": worst, "ms": med["kernel"],
                      "plain_ms": med["plain"], "library_ms": med["library"],
                      "bound_ms": bound, "bound_by": "bytes"}


def phase_conv(device) -> tuple[int, dict]:
    """B4: its SASS; one ulp of the plain version and of cuDNN at small
    shapes, the closed form of the constant case; then the conv probe at
    the trunk's shape; returns the probe's launches and the kernel's
    row."""
    counter = conv_ops.conv3x3_cuda
    sass = conv_kernel_probe.sass_report()
    log(f"kernels: conv3x3 build: {json.dumps(sass)}")
    ops = sass["sass"]
    check(ops["HGMMA"] > 0 and ops["UBLKCP"] > 0 and ops["HMMA"] == 0,
          f"conv3x3 SASS: {ops}")
    cases = [(h, w, *conv_kernel_probe.inputs(h, w, device, seed=h), None)
             for h, w in CONV_SHAPES]
    cases += [(h, w, *conv_kernel_probe.constant_case(h, w, device))
              for h, w in ((9, 33), (1, 100))]
    for h, w, x, wgt, exact in cases:
        tag = f"conv ({h}, {w}){' constant' if exact is not None else ''}"
        before = counter.launches
        got = conv_ops.conv3x3_cuda(x, wgt)
        check(counter.launches == before + 1, f"{tag}: launches")
        if exact is not None:
            check(torch.equal(got, exact), f"{tag}: not the closed form")
        abs_sum = conv_ops.conv3x3_f32(x.abs(), wgt.abs())
        for name, want in (("plain", conv_ops.conv3x3_ref(x, wgt)),
                           ("cuDNN", conv_ops.conv3x3_library(x, wgt))):
            rep = conv_ops.ulp_report(got, want, abs_sum)
            check(rep["ok"], f"{tag} vs {name}: {rep}")
            log(f"kernels: {tag} vs {name}: {rep}")

    # The main path: the conv probe on the card.
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    probe = conv_kernel_probe.run(device)
    launches = counter.launches
    check(launches == probe["kernel_calls"],
          f"conv probe: {launches} launches for {probe['kernel_calls']} "
          f"passes")
    log(f"conv probe: {json.dumps(probe)}")
    by_ops = probe["flop"] / BF16_FLOP_PER_S * 1e3
    by_bytes = probe["bytes"] / HBM_BYTES_PER_S * 1e3
    return launches, {"max_abs_err": probe["vs_plain"]["max_abs"],
                      "ms": probe["ms"]["kernel"],
                      "plain_ms": probe["ms"]["plain"],
                      "library_ms": probe["ms"]["library"],
                      "bound_ms": max(by_ops, by_bytes),
                      "bound_by": "operations" if by_ops >= by_bytes
                      else "bytes"}



# -- the diagnostics phase ----------------------------------------------------

# Solvers (and their run dirs) that an earlier phase trained and the
# diagnostics phase uses: "train" (gmfnet) and "train_gan" (two-stage).
KEPT: dict[str, tuple] = {}
# The result workbooks of the CLI runs, copied for ``collect``, and each
# run's test OA by its tag.
RESULTS = {"dir": None, "oa": {}}


def _release(tmp: str) -> None:
    """Remove a phase's run dir, unless a kept solver still uses it."""
    if all(tmp != d for _, d in KEPT.values()):
        shutil.rmtree(tmp, ignore_errors=True)


def _keep_workbook(cfg, tag: str, oa: float) -> None:
    """Copy a CLI run's ``*_result.xlsx`` (its test OA ``oa``) under the
    results dir, as ``{tag}/{its name}``, for the diagnostics phase's
    ``collect``."""
    if RESULTS["dir"] is None:
        RESULTS["dir"] = tempfile.mkdtemp(prefix="chip_smoke_results_")
    d = os.path.join(RESULTS["dir"], tag)
    os.makedirs(d, exist_ok=True)
    shutil.copy(cfg["RESULT_excel"], d)
    RESULTS["oa"][tag] = oa


class SingleNet(torch.nn.Module):
    """An MS-only classifier of the shared blocks, registered with arity
    ``single``: gmfnet's MS branch and trunk (a stem, residual blocks to
    4w, the MLP head) on the (B, ps, ps, C) MS window alone."""
    flax_root = "MSNet"

    @classmethod
    def widths_from_tree(cls, tree) -> dict:
        return {"model_width": 2 * tree_shape(tree, "ConvBlock_0", "Conv_0",
                                              "kernel")[-1]}

    def __init__(self, cfg, width: int = 64):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        w = int(cfg.get("model_width", width))
        c = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.stem = ConvBlock(c, w // 2, 3, 1, act)
        self.blocks = torch.nn.Sequential(ResBlock(w // 2, w, 1, act),
                                          ResBlock(w, 2 * w, 2, act),
                                          ResBlock(2 * w, 4 * w, 2, act))
        self.head = MLPHead(4 * w, int(cfg["Categories_Number"]),
                            hidden=2 * w, act=act)

    def forward(self, ms: torch.Tensor) -> torch.Tensor:
        ms = ms.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            return self.head(self.blocks(self.stem(ms)))


def _register_single() -> None:
    """``SingleNet`` as ``SINGLE_NAME``, from a module that declares
    ``ARITY = "single"`` (the registry reads a registered model's module)."""
    mod = types.ModuleType(f"chip_smoke_models.{SINGLE_NAME}")
    mod.ARITY, mod.Net = "single", SingleNet
    SingleNet.__module__ = mod.__name__
    sys.modules[mod.__name__] = mod
    register(SINGLE_NAME)(SingleNet)


def _png_hw(path: str) -> tuple[int, int]:
    """A PNG's (height, width) from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR",
          f"diagnostics: {path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _h5_check(solver) -> dict:
    """One epoch of the trained gmfnet's train ids, batches of 256:
    through ``H5DualPrograms`` on the rows that ``gather_patches`` (the
    cache's arrays, without a file) gives, and through ``DualPrograms`` on
    the scene (B1 once a batch), each from a copy of the solver's
    weights with a fresh Adam, cuDNN deterministic: losses within
    H5_LOSS_ATOL."""
    from dmfusion_torch.train.optim import make_optimizer
    from dmfusion_torch.train.steps import H5DualPrograms
    from dmfusion_torch.utils.h5cache import gather_patches
    cfg, scene = solver.cfg, solver.scene
    ids, labels, mask, _ = solver.batches(solver.split.train, TRAIN_BATCH,
                                          shuffle=True)
    mask = mask.float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = gather_patches(scene, ids.reshape(-1).cpu().numpy())
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    check(torch.equal(cache["label"].reshape(ids.shape).to(labels.dtype),
                      labels), "diagnostics: the cache's labels != the "
          "batches'")
    rows = torch.arange(ids.numel(), dtype=torch.int32,
                        device=ids.device).reshape(ids.shape)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    out = {}
    try:
        for name, cls, args, batch in (
                ("scene", DualPrograms, solver.scene_args, ids),
                ("h5", H5DualPrograms, (cache["ms"], cache["pan"]), rows)):
            model = copy.deepcopy(solver.model)
            prog = cls(model, make_optimizer(cfg, model.parameters(),
                                             ids.shape[0]),
                       cfg, scene.width, scene.patch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = prog.train_epoch(args, batch, labels, mask).cpu()
            out[name] = (losses, time.perf_counter() - t0,
                         [p.detach() for p in model.parameters()])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    loss_err = float((out["h5"][0] - out["scene"][0]).abs().max())
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(out["h5"][2], out["scene"][2],
                                    strict=True))
    check(bool(torch.isfinite(out["h5"][0]).all())
          and loss_err <= H5_LOSS_ATOL,
          f"diagnostics: H5DualPrograms' losses {loss_err} from "
          f"DualPrograms' (limit {H5_LOSS_ATOL})")
    del cache
    return {"steps": int(ids.shape[0]), "rows": int(ids.numel()),
            "gather_s": gather_s, "scene_epoch_s": out["scene"][1],
            "h5_epoch_s": out["h5"][1], "loss_max_abs": loss_err,
            "param_max_abs": param_err,
            "mean_loss": float(out["h5"][0].mean())}


def _single_run(tmp: str, device) -> dict:
    """The single arity through the CLI (``SINGLE_SET``), its test over
    the first SINGLE_BUCKETS buckets of its test split, the export of its
    best weights served in SINGLE_REQUESTS requests: returns what it
    measured and its batches, each one gather_one_fast launch."""
    from dmfusion_torch import cli
    from dmfusion_torch import export as export_cli
    from dmfusion_torch.train.steps import SinglePrograms
    t0 = time.perf_counter()
    solver = cli.main(["--set", *SINGLE_SET, f"expo_result={tmp}/"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cfg, split, rec = solver.cfg, solver.split, solver.records
    check(type(solver.programs) is SinglePrograms
          and len(solver.scene_args) == 1
          and solver.model.stem.conv.out_channels == 32
          and cfg["patch_size"] == 16 and cfg["batchsize"] == TRAIN_BATCH
          and solver.device.type == "cuda",
          "diagnostics: the single run is not SingleNet w64, patch 16, "
          "batch 256 on SinglePrograms on the card")
    check(rec["Epoch"] == [0] and all(np.isfinite(rec["Loss"]
                                                  + rec["ValLoss"])),
          f"diagnostics: single records {rec}")
    ev = solver._eval_round_to()
    val = -(-len(split.valid) // ev)
    train_steps = -(-len(split.train) // TRAIN_BATCH)
    # A test pass of repeat 0 (the run's loop has moved past it) over a
    # subset of the test split, in buckets of 4096.
    split.test = split.test[:SINGLE_BUCKETS * BUCKET]
    solver.time = 0
    solver.test()
    torch.cuda.synchronize()
    check(ev == BUCKET and int(solver.test_matrix.sum()) == len(split.test),
          "diagnostics: the single test matrix does not sum to its subset")
    aa, oa, kap, _ = solver.last_result
    _keep_workbook(cfg, "single", oa)
    art = os.path.join(tmp, "single.zip")
    export_cli.main(["--set", *SINGLE_SET, "--weights",
                     os.path.join(cfg["RESULT_output"], "0_weights.pt"),
                     "--out", art])
    clf = load_artifact(art, device)
    check(clf.manifest["arity"] == "single"
          and len(clf.manifest["input_shapes"]) == 1,
          f"diagnostics: single manifest {clf.manifest}")
    pred = ScenePredictor(clf, solver.scene, bucket=BUCKET)
    chunks = np.random.default_rng(17).choice(
        split.labeled, SINGLE_REQUESTS * BUCKET, replace=False).astype(
        np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = pred.predict_ids(chunks)
    request_ms = (time.perf_counter() - t0) * 1e3 / SINGLE_REQUESTS
    check(np.array_equal(served, solver._predict_ids(chunks, BUCKET)),
          "diagnostics: served single predictions != the solver's")
    result = {"model": SINGLE_NAME, "width": 64, "patch": 16,
              "run_s": run_s, "epoch_s": rec["EpochTime"],
              "loss": rec["Loss"], "val_oa": rec["ValOA"],
              "train_steps": train_steps, "val_batches": val,
              "test_anchors": len(split.test), "test_s": solver.test_time,
              "test_oa": oa, "request_ms": request_ms,
              # train, val, test, the served requests and the solver's own
              # prediction of them: one gather_one_fast launch a batch.
              "b1_batches": (train_steps + val + SINGLE_BUCKETS
                             + 2 * SINGLE_REQUESTS),
              "scene": solver.scene}
    return result


def phase_diagnostics(device) -> tuple[int, int, dict]:
    """visualize on the solvers that train and train_gan trained, the
    t-SNE on the card against the CPU, the patch cache's programs against
    the scene's, the single arity trained, tested, exported and served,
    and ``collect`` over the CLI runs' workbooks.  Returns B1's launches
    on the diagnostics path and on the single path, and the single path's
    gather_one_fast timing."""
    from dmfusion_torch.report import collect
    from dmfusion_torch.report import tsne as tsne_mod
    from dmfusion_torch.report.viz import SCATTER_HW
    t_phase = time.perf_counter()
    gm, gm_tmp = KEPT["train"]
    ts, ts_tmp = KEPT["train_gan"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_diagnostics_")
    try:
        for spec in KERNELS.values():
            spec["counter"].launches = 0
        t0 = time.perf_counter()
        gm.visualize()
        torch.cuda.synchronize()
        vis_s = time.perf_counter() - t0
        png = os.path.join(gm.cfg["RESULT_output"],
                           f"{gm.time}_tsne_test.png")
        check(_png_hw(png) == SCATTER_HW and gm.tsne.xy.is_cuda
              and tuple(gm.tsne.xy.shape) == (TSNE_POINTS, 2)
              and np.isfinite(gm.tsne.kl_divergence),
              f"diagnostics: gmfnet's scatter {_png_hw(png)}, "
              f"{tuple(gm.tsne.xy.shape)}, KL {gm.tsne.kl_divergence}")
        # The same 2,000 test anchors' logits, as visualize draws them.
        ids = np.sort(np.random.default_rng(int(gm.cfg["seed"])).choice(
            gm.split.test, TSNE_POINTS, replace=False))
        logits = gm._anchor_logits(ids)
        with ThreadPoolExecutor(1) as pool:
            t_cpu = time.perf_counter()
            cpu_job = pool.submit(tsne_mod.tsne, logits.cpu().double())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = tsne_mod.tsne(logits)
            torch.cuda.synchronize()
            tsne_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ts.visualize()
            torch.cuda.synchronize()
            vis_streams_s = time.perf_counter() - t0
            n4 = 4 * (TSNE_POINTS // 4)
            png = os.path.join(ts.cfg["RESULT_output"],
                               f"{ts.time}_tsne_streams.png")
            check(_png_hw(png) == SCATTER_HW
                  and tuple(ts.tsne.xy.shape) == (n4, 2)
                  and np.isfinite(ts.tsne.kl_divergence),
                  f"diagnostics: the streams' scatter {_png_hw(png)}, "
                  f"{tuple(ts.tsne.xy.shape)}")
            h5 = _h5_check(gm)
            visual = {n: spec["counter"].launches
                      for n, spec in KERNELS.items()}
            # visualize, the logits above, the streams' visualize: one
            # gathered batch each; the scene's epoch: one a batch.
            want = 1 + 1 + 1 + h5["steps"]
            check(visual["gather_windows"] == want
                  and visual["phase_pool"] == visual["strip_gather"]
                  == visual["conv3x3"] == 0,
                  f"diagnostics: launches {visual}, B1 should be {want}")
            for spec in KERNELS.values():
                spec["counter"].launches = 0
            single = _single_run(os.path.join(tmp, "single"), device)
            single_launches = {n: spec["counter"].launches
                               for n, spec in KERNELS.items()}
            cpu = cpu_job.result()
            cpu_s = time.perf_counter() - t_cpu
        check(single_launches["gather_windows"] > 0
              and single_launches["gather_windows"]
              == single["b1_batches"]
              and single_launches["phase_pool"]
              == single_launches["strip_gather"]
              == single_launches["conv3x3"] == 0,
              f"diagnostics: the single path launched {single_launches}; "
              f"its batches are {single['b1_batches']}")
        sc = single.pop("scene")
        single_b1 = {}
        for b in (TRAIN_BATCH, BUCKET):
            ids_t = torch.from_numpy(np.random.default_rng(b).integers(
                0, sc.num_pixels, b, dtype=np.int32)).to(device)
            check(torch.equal(
                gather_ops.gather_one_fast(sc.ms, ids_t, sc.width, sc.patch),
                gather_one(sc.ms, ids_t, sc.width, sc.patch)),
                f"diagnostics: gather_one_fast != gather_one at B {b} on the "
                f"single path's scene")
            single_b1[f"B{b}"] = time_gather(
                sc, (sc.ms,), (gather_one, gather_ops.gather_one_fast), b,
                np.random.default_rng(18))
        del sc
        p_card, p_cpu = card.p.cpu(), cpu.p
        off = p_cpu > 0
        p_err = float(((p_card - p_cpu).abs()[off] / p_cpu[off]).max())
        kl_share = abs(card.kl_divergence - cpu.kl_divergence) / \
            cpu.kl_divergence
        log(f"diagnostics: t-SNE of {TSNE_POINTS} points: card {tsne_s:.3f} "
            f"s, KL {card.kl_divergence} (it {card.n_iter}); CPU float64 "
            f"{cpu_s:.3f} s, KL {cpu.kl_divergence} (it {cpu.n_iter}); P "
            f"max rel {p_err}, KL share {kl_share}; visualize KL "
            f"{gm.tsne.kl_divergence}, streams KL {ts.tsne.kl_divergence}; "
            f"patch cache {json.dumps(h5)}")
        check(p_err <= TSNE_P_RTOL and kl_share <= TSNE_KL_SHARE,
              f"diagnostics: t-SNE on the card vs the CPU: P {p_err} "
              f"(limit {TSNE_P_RTOL}), KL {card.kl_divergence} vs "
              f"{cpu.kl_divergence} ({kl_share}, limit {TSNE_KL_SHARE})")
        # collect over the CLI runs' workbooks: one (run, repeat) row and
        # one mean row each, a blank row between runs, in run order; each
        # run's OA the one its solver computed.
        kept = RESULTS["oa"]
        n_books = len(list(collect.iter_run_workbooks(RESULTS["dir"])))
        summary = collect.collect_results(
            RESULTS["dir"], os.path.join(tmp, "summary.xlsx"))
        from dmfusion_torch.report.excel import Workbook
        sheet = Workbook.load(summary)["summary"]
        rows = [r for r in range(2, 3 * n_books + 2)
                if sheet.cell(r, 1) is not None]
        got = {sheet.cell(r, 1).split("/")[0]: sheet.cell(r, 3)
               for r in rows[::2]}
        check(n_books == len(kept) and len(rows) == 2 * n_books
              and [sheet.cell(r, 2) for r in rows] == [0, "mean"] * n_books
              and sheet.cell(3 * n_books + 1, 1) is None
              and got.keys() == kept.keys()
              and all(abs(got[t] - kept[t]) <= 1e-12 for t in kept),
              f"diagnostics: collect gave {len(rows)} rows for {n_books} "
              f"workbooks, OA {got} against {kept}")
        result = {
            "card": card_line(), "visualize_s": vis_s,
            "visualize_streams_s": vis_streams_s, "tsne_points": TSNE_POINTS,
            "tsne_card_s": tsne_s, "tsne_cpu_f64_s": cpu_s,
            "tsne_card": {"kl": card.kl_divergence, "n_iter": card.n_iter},
            "tsne_cpu": {"kl": cpu.kl_divergence, "n_iter": cpu.n_iter},
            "tsne_p_max_rel": p_err, "tsne_kl_share": kl_share,
            "visualize_kl": gm.tsne.kl_divergence,
            "streams_kl": ts.tsne.kl_divergence, "h5": h5,
            "single": single, "single_b1": single_b1,
            "launches": {"diagnostics": visual["gather_windows"],
                         "single": single_launches["gather_windows"]},
            "collect_workbooks": n_books,
            "phase_s": time.perf_counter() - t_phase}
    finally:
        for name in ("train", "train_gan"):
            KEPT.pop(name, None)
        for d in (tmp, gm_tmp, ts_tmp):
            shutil.rmtree(d, ignore_errors=True)
    del gm, ts
    torch.cuda.empty_cache()
    log(f"diagnostics: {json.dumps(result)}")
    return (visual["gather_windows"], single_launches["gather_windows"],
            result["single_b1"])


def main() -> None:
    try:
        _main()
    finally:
        for _, d in KEPT.values():
            shutil.rmtree(d, ignore_errors=True)
        if RESULTS["dir"] is not None:
            shutil.rmtree(RESULTS["dir"], ignore_errors=True)


def _main() -> None:
    t_start = time.perf_counter()
    secs = {}

    def phase(name, fn, *args):
        """``fn(*args)``, its seconds logged and kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        log(f"phase {name}: {secs[name]:.1f} s")
        return out

    device, card = phase("device", phase_device)
    _register_single()
    phase("build", phase_build)
    t0 = time.perf_counter()
    scene = synthetic_scene(load_config(overrides=CFG), device=device)
    torch.cuda.synchronize()
    log(f"scene: {CFG['data_city']} synthetic, ms {tuple(scene.ms.shape)} pan "
        f"{tuple(scene.pan.shape)} {scene.ms.dtype}, "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mspan = mspan_scene(scene, CFG["seed"])
    torch.cuda.synchronize()
    log(f"scene: MSPAN {tuple(mspan.shape)} {mspan.dtype} built in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (first build)")
    t0 = time.perf_counter()
    gan = gan_scenes(scene)
    quad = quad_streams(scene, *gan, device)
    torch.cuda.synchronize()
    log(f"scene: seeded stage-1 scenes and the four quad streams "
        f"{tuple(quad[0].shape)} built in {time.perf_counter() - t0:.2f} s")
    secs["scene"] = time.perf_counter() - t_start - sum(secs.values())
    timings = phase("kernels", phase_kernels, scene, device, mspan, quad)
    # Each path is driven with every count set to 0 just before it and read
    # just after; a kernel's launches are those of its own path.
    served = phase("serving", phase_serving, scene, device)
    by_path = {"serving": served["gather_windows"]}
    timings["group_norm_act"] = phase("norm", phase_norm)
    timings["window_attn"], attn_launches = phase("attn", phase_attn)
    timings["phase_pool"] = phase("pool", phase_pool, scene, device)
    pool_by_path = {"dense": phase("dense", phase_dense, scene,
                                   device)["phase_pool"]}
    by_path["train"] = phase("train", phase_train, scene, device)
    by_path["train_dp"], timings["gather_windows"]["sharded"] = \
        phase("train_dp", phase_train_dp)
    by_path["train_dp_streams"], timings["gather_windows"][
        "sharded_streams"] = phase("train_dp_streams", phase_train_dp_streams)
    by_path["train_dp_maps"], pool_by_path["train_dp_maps"] = \
        phase("train_dp_maps", phase_train_dp_maps)
    by_path["train_tp"], pool_by_path["train_tp"] = \
        phase("train_tp", phase_train_tp, scene)
    pool_by_path["train_dense"] = phase("train_dense", phase_train_dense,
                                        scene, device)
    by_path["train_conv"], timings["gather_windows"]["patch47"] = \
        phase("train_conv", phase_train_conv, device)
    by_path["train_tri"], timings["gather_windows"]["tri"] = \
        phase("train_tri", phase_train_tri, scene, device, mspan)
    del mspan
    by_path["train_quad"] = phase("train_quad", phase_train_quad, scene,
                                  device, quad, gan)
    del quad, gan
    by_path["train_gan"] = phase("train_gan", phase_train_gan, scene, device)
    by_path["diagnostics"], by_path["single"], timings["gather_windows"][
        "single"] = phase("diagnostics", phase_diagnostics, device)
    by_path["zoo"] = phase("zoo", phase_zoo, scene, device)
    by_path["train_ct"] = phase("train_ct", phase_train_ct, device)
    launches = {"gather_windows": sum(by_path.values()),
                "phase_pool": sum(pool_by_path.values()),
                "group_norm_act": served["group_norm_act"],
                "window_attn": attn_launches}
    launches["strip_gather"], timings["strip_gather"] = phase(
        "strip", phase_strip, scene, device)
    del scene
    launches["conv3x3"], timings["conv3x3"] = phase("conv", phase_conv,
                                                    device)
    log(f"phase seconds: {json.dumps(secs)}, "
        f"{time.perf_counter() - t_start:.1f} s in all")
    rows = []
    for name, spec in KERNELS.items():
        t = timings[name]
        check(launches[name] > 0, f"{name} never launched on the main path")
        rows.append({"name": name, "route": spec["route"],
                     "source": spec["source"], "replaces": spec["replaces"],
                     "launches": launches[name], "ok": True,
                     **({"launches_by_path": by_path}
                        if name == "gather_windows" else {}),
                     **({"launches_by_path": pool_by_path}
                        if name == "phase_pool" else {}),
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "unit": spec["unit"],
                     **({k: t[k] for k in ("one", "single", "patch47", "tri",
                                           "quad", "sharded",
                                           "sharded_streams")}
                        if name == "gather_windows" else {}),
                     **({k: t[k] for k in ("max_ulps", "bit_equal_share",
                                           "request")}
                        if name == "group_norm_act" else {}),
                     **({k: t[k] for k in ("max_rel_err", "request", "served")}
                        if name == "window_attn" else {})})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
