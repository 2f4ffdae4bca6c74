#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs nvcc and a CUDA card

Phases (any failure raises and the script exits non-zero):

1. build   -- compile the seven CUDA sources (eight kernels) from
              ``src/repro_torch/csrc`` (one nvcc per source, all at once)
              and time it;
2. edges   -- each kernel against its plain PyTorch version on the card on
              edge cases; bit for bit (tolerance 0) for the integer kernels:
              .5 ties, negatives, |q| near 2**25 and 2**31 (wrapping
              differences), X % 4 of 1-3, ragged tiles, rows and bases off
              16 bytes, X = 1, Z = 1 and ranks 0-2, z across the 32-plane
              segments a warp marches at each vector width; spans
              above 4096, short last chunks, codes longer than the 12-bit
              LUT up to the 32-bit maximum codeword; the lane histogram at
              L = 1 and 512, lanes piled on one bin, spans at the
              shared-memory limit, just past it and above 2**16, rows off a
              16-byte boundary; the encode at chunk sizes 1, 31, 255, 256,
              257, 1024 and MAX_CHUNK (both of its forms) with pad slots and
              32-bit codes, and on rows off a 16-byte boundary; values on / below /
              above the group edges, duplicate edges, G = 1, 20 and the
              largest G; the decode alone at chunk sizes 1 and MAX_CHUNK,
              32-bit codes and escapes among one warp's chunks, an alphabet
              past 4,096 symbols, int32 offsets, a zeroed and a truncated
              stream; for ``enhancer_fused`` within
              |diff| <= 1e-5 (1 + max|plain|) (the kernel fuses multiply-adds
              the plain version rounds twice): G = 1 on 1x1 .. 64x64 slices,
              ids changing inside the halo, an inactive group, the clamp,
              direct (non-residual) mode, 9 groups in one 3x3 neighbourhood,
              20 in one block, groups changing on block borders, H or W of
              1, G = 287 and 4,096 (and bit for bit on a subset of slices);
3. main    -- the main path at full size: nyx_like_field((512,)*3,
              "temperature", seed=0), tile 64^3, rel_eb 1e-3, huffman+zlib,
              through compress_tiled -> to_bytes -> from_bytes ->
              decompress_tiled and decompress_region; launch counters are
              zeroed just before and read just after (as in every phase
              below), and read after the compress too: it must launch
              symbol_hist and huffman_encode once each, for all 512 lanes;
3b. legacy -- the entropy codec's read leftovers: encode_codes_legacy of
              the main field's 512 lane codes (hz) and of the 128^3 corner's
              whole-volume stream (hf), bytes equal to the CPU route's (every
              eighth lane and the stream), their decode on the card (one
              boundary pass, huffman_legacy, then one huffman_decode a blob)
              equal to the codes, decode_codes_range equal to the full
              decode's slice on hZ/hz lanes and hc/hf streams; the boundary
              pass against its plain version (edge cases: codes past the
              12-bit LUT, an alphabet past 4,096 symbols, one symbol, 100
              symbols), then timed on a lane and on the stream beside its
              bound (bytes read over 3.35 TB/s);
4. gwlz    -- the GWLZ enhancer path on the same field at the paper's model
              width (G = 20, C = 9, batch 10; 1 epoch, cut from 300):
              GWLZ.compress_tiled -> to_bytes -> from_bytes -> enhanced
              decompress_tiled and decompress_region.  Checks: the decode's
              PSNR equals the compress-time psnr_gwlz, region == full crop
              bit for bit, psnr_gwlz >= psnr_sz - 1e-3, group_hist and
              enhancer_fused launched, symbol_hist and huffman_encode once
              each in the compress.  On this field at rel_eb 1e-3 the
              quantile edges collapse and only 2 of the 20 groups hold values;
5. gwlz_all_groups -- the same path and checks on
              nyx_like_field((512,)*3, "velocity_x", seed=0), where all 20
              quantile groups hold values (checked), so every model trains
              and the grouped kernel meets group borders everywhere;
6. szjx    -- the monolithic SZ path through the façade on the temperature
              field: api.compress(predictor="lorenzo", not tiled) -> api.save
              -> api.open -> np.asarray(vol) and vol[the main ROI].  Checks:
              max error <= eb (1 + 1e-6), decode == compress-time
              reconstruction and slice == full crop bit for bit; the 128^3
              corner's SZJX bytes equal on the card and the CPU;
              lorenzo_quant, huffman_encode and huffman_decode launched;
7. interp  -- the default SZ path (interp, cubic) through the façade on the
              temperature field: api.compress with no predictor (one stream
              of the 513^3 padded volume's codes) -> api.save -> api.open ->
              np.asarray(vol) and vol[the main ROI].  Checks: max error <=
              float32(eb) exactly, decode == the compress-time
              reconstruction and slice == full crop bit for bit, the coarse
              grid's lorenzo_quant and the three Huffman kernels launched.
              Prints the levels, padded shape, outliers, straggler rounds
              and the device ms of one encode and one decode of the sweeps
              (torch ops; CUDA events);
8. interp_tiled -- compress_tiled(predictor="interp") over 64^3 tiles (512
              lanes of 65^3 padded tiles), container round trip, full decode
              and the region read; checks and prints as for interp, plus one
              symbol_hist and one huffman_encode launch per compress;
9. stream  -- the out-of-core path: the temperature field saved to a .npy
              and streamed off its memmap under the reference's default
              256 MiB budget (tile 64^3, rel_eb 1e-3, huffman+zlib; Lorenzo
              32 tiles a batch, 16 batches; interp 23, 23 batches, the last
              short).  (a) Lorenzo bytes == main's eager container; (b)
              transient device and append faults, retries == 2, same bytes;
              (c) a hard fault leaves the journal, resume=True finishes it,
              same bytes, open(verify="full"); (d) interp bytes ==
              interp_tiled's, error <= float32(eb), ROI == crop; (e) enhancers
              trained 5 epochs on the reservoir (32 tiles, 2,048 slices of
              64x64), full decode, ROI == crop, PSNRs printed; (f) tracked
              peak <= 2 x budget; (g) the three encode kernels once a batch,
              group_hist and enhancer_fused in (e), huffman_decode on the
              read-backs.  Prints each run's compress and host-stage seconds,
              tile-read seconds, geometry, tracked and device peaks (the
              eager main's beside them), and one batch's pageable upload;
10. gwlz_mono -- the paper's configuration: api.compress(predictor="lorenzo",
              enhance=GWLZTrainConfig(epochs=3)) on the same field, the
              enhancers trained on 512 full 512x512 slices (51 steps an
              epoch; 3 epochs, cut from 300), then save, open, full decode
              and the ROI.  Checks as for gwlz;
11. gwlz_interp -- the same on the default predictor (interp): the paper's
              GWLZ over its SZ3-class baseline (3 epochs, cut from 300);
12. bigstream -- one SZJX Lorenzo field whose single Huffman stream is past
              2**31 bits (integer noise on [0, 2**16) at 512^3, abs_eb 0.5,
              ``huffman`` backend): api.compress -> save -> open -> full
              decode on the card, within eb (1 + 1e-6) and equal to x; the
              stream's bits are printed; and [0, 1) noise at 64^3, rel_eb
              1e-5, whose error past eb (float32 rounding of 2eb q, as in the
              reference) is printed, with the card's bytes equal to the CPU's;
12b. serve -- the serving daemon: one RegionServer on 127.0.0.1:0 over
              the gwlz phase's enhanced tiled volume, the main Lorenzo
              container and the szjx file, one shared 256 MiB cache, a 256
              MiB admission budget, a 2 ms batcher window; 100 client
              threads x 3 requests over 32 seeded overlapping ROIs (1-8
              lanes inside one 4x4x4-lane block; every eighth a monolithic
              crop).  Checks: every body equals np.save of the crop of an
              eager full decode through a separate handle, hit rate >= 0.5,
              no error or 503, a repeat with the ETag gets 304 with no decode
              (dispatch and launch counters unmoved), and 100 concurrent
              single-lane reads in process make >= 2x fewer decode dispatches
              with the batcher than without.  Prints client p50/p99 and
              req/s, the hit rate, the batcher's and admission's counters,
              the storm's launches per kernel and the device peak;
12c. gwds  -- a two-field snapshot of 512^3 fields in one GWDS file:
              GWDSWriter.add_field of main's tiled Lorenzo artifact, then
              stream_field of the same field from the stream phase's .npy
              memmap under 256 MiB (the executor writing into the envelope's
              shared sink), finalize.  Checks: the streamed field's bytes ==
              main's container (sha256), api.open (mmap) lists both fields,
              each decodes bit for bit to main's eager decode, the ROI ==
              the crop, Dataset.build of the two artifacts == the file's
              bytes, ``cli info``, ``region --field`` and ``verify`` exit 0
              in subprocesses, and an append fault in a streamed field fails
              after one attempt (no retry on a shared sink).  Prints the
              write, stream, open, decode and region times, the envelope's
              bytes and size_report, and launches;
12d. checkpoint -- (a) a seeded training state on the card (proj float32
              [4096, 4096]: the SZ branch, as every 2-D leaf; experts
              [8, 1024, 2048]: the GWLZ branch, 30 epochs, G = 8; emb
              bfloat16 [32000, 128]: SZ interp; norm [4096] and an int64
              step: exact)
              saved by an async CheckpointManager(gwlz_rel_eb=1e-4), waited
              for and restored into like-shaped tensors on the card: every
              compressed leaf within eb (1 + 1e-5) plus one float32 ulp of
              max|x| (the interp coarse grid's 2eb q rounding; twice that
              where the GWLZ gate kept a group; bfloat16 also its cast's
              half ulp), exact leaves bit-equal, dtypes and devices kept;
              prints the save (host copy), wait and restore seconds and
              each leaf's bytes on disk against raw.  (b) a ResilientLoop over
              core/trainer.py::train_step (G = 20, C = 9, batch 10 of the
              szjx decode's 512x512 planes and residuals), 40 steps, a
              checkpoint every 10, once clean and once with failures
              injected at steps 17 and 31, cuDNN deterministic, each run
              with a HeartbeatMonitor: restarts 0 and 2, final parameters,
              BN state and AdamW moments bit for bit equal, one heartbeat a
              step run (up to the window); prints ms a step, the seconds a
              restart costs, and each run's median heartbeat and
              stragglers;
12e. gwlz_dist -- the distributed GWLZ step (launch/gwlz_dist.py) at the
              gwlz-nyx widths, G = 32, C = 9, 512x512 slices, DIST_BATCH
              slices a step (gwlz_nyx's global batch is 512: cut to fit one
              card): x the szjx decode's slices, r the field minus them,
              edges compute_edges(x, 32), rscale the per-group max |r|;
              DIST_STEPS steps with gradient compression off, then on.
              Checks: finite losses, group_hist launched once a step, and
              grad_compress.apply through a one-rank NCCL group (tcp on
              localhost) equal bit for bit to the single-shard apply.
              Prints ms a step for each run, the device peak, and the
              gradients' int8 code bytes against their float32 bytes;
12f. lm_train -- granite-3-8b at full width (d 4096, 32 heads, kv 8,
              head_dim 128, ff 12800, vocab 49155), 4 of its 40 layers
              (~1.0 B parameters), batch 4 x seq 2048: (a) ResilientLoop
              over launch/steps.py's step with bf16 moments, 20 steps, a
              plain checkpoint every 10, once clean and once with a failure
              at step 13, under deterministic algorithms: the loss falls
              and the restarted run ends bit-equal to the clean one; (b)
              five steps each with bf16 and int8 moments, synchronized and
              timed one by one (int8 diverges within a dozen steps in both
              packages, so the loop runs bf16); (c) the trained embedding
              [49155, 4096] alone through compress_tensor at rel_eb 1e-4
              (the SZ branch) within its bound; (d) the reference test's
              command through ``python -m repro_torch.launch.train
              --reduced`` on the card, exit 0.  Prints ms a step, tokens/s,
              the share of the bf16 dense peak (6 N tokens over the step
              time), save, wait and restore seconds, the seconds a restart
              costs, the device peak, and the embedding's ratio, seconds
              and error over eb;
12g. lm_serve -- LM serving (launch/serve.py, models/ decode caches)
              in five checks, each a JSON line with ms a decode step,
              tokens/s, KV-cache bytes and the device peak: (a) gemma3-1b
              at full width and depth (26 layers, d 1152, 4 heads, kv 1,
              head_dim 256, vocab 262144, 5:1 sliding(512):global) through
              ``launch.serve.main`` in bf16, batch 8, ctx 2048, prompt 512,
              128 generated (the 512-slot rings wrap once, the global
              caches fill 639 of 2,048), then one steady step under
              torch.profiler (device operations a step, device busy share)
              and the weight-plus-cache bytes a step reads over the step
              time as a share of 3.35 TB/s; (b) gemma3-1b at full
              width in float32, its first 6 layers (one 5:1 period; depth
              is the only cut), batch 2, 1,024 positions (two 512-query
              blocks, so the sliding layers' prefill is banded): ``apply``
              against the per-step ``decode_step`` logits, max relative
              error < 2e-3;
              (c) llama4-scout-17b-a16e and deepseek-v3-671b at full width,
              their first 4 layers (llama4: 3 chunked(8192) + 1 NoPE
              global, all MoE 16e top-1 + shared; deepseek: 3 dense + 1 MoE
              256e top-8, MLA), bf16, batch 4, 64 decode steps: finite
              logits, the MLA cache latent-sized; (d) the three reduced
              configs in float32, 12 decode steps on the card against the
              CPU's within 1e-4 max|logits|; (e) ``python -m
              repro_torch.launch.serve --arch gemma3-1b --reduced`` on the
              card, exit 0.  No kernel of ``csrc/`` runs here (attention,
              MoE dispatch and MLA are plain torch, as they are plain
              ``jnp`` in the reference), and none may be launched;
12h. lm_families -- the recurrent, hybrid, M-RoPE and encoder-decoder
              families (models/ssm.py, models/encdec.py) in seven checks:
              (a)-(d) each arch at full width and depth through
              ``launch.serve.main``, bf16, batch 8: zamba2-1.2b (38 layers,
              32 Mamba2 + 6 invocations of one shared attention block; ctx
              2048, prompt 128, 128 generated), then one steady step under
              torch.profiler; rwkv6-7b (32 layers; prompt 64, 64
              generated); qwen2-vl-7b (28 layers, M-RoPE decode positions;
              ctx 2048, prompt 128, 128 generated); whisper-small (12 + 12
              layers, 1,500 encoder frames encoded once; ctx 448, prompt 4,
              128 generated; the encode's seconds).  Each prints ms a step,
              tokens/s, weight, cache and state bytes, and the HBM share:
              the bytes a step reads at least (every weight once, the
              shared block once an invocation, rwkv6's unread ``ffn`` left
              out, every cache and state, whisper's encoder output twice a
              layer) over the step, of 3.35 TB/s; (e) decode == prefill in
              float32 at full width over 128 positions, max relative error
              < 2e-3, depth cut to rwkv6 2, zamba2 6 (one period), qwen2-vl
              2 (distinct h and w streams), whisper 2 + 2; (f) the four
              reduced configs in float32, 12 decode steps, one training
              loss and its gradients on the card against the CPU within
              1e-4 of the largest value; (g) ``launch.serve --reduced`` for
              the four and ``launch.train --reduced`` (40 steps, a failure
              at 12) for whisper-small, qwen2-vl-7b and zamba2-1.2b as
              subprocesses, all at once: exit 0, one restart, the loss
              falls.  No kernel of ``csrc/`` may be launched;
12i. dryrun -- LM sharding, microbatching and the dry run in four
              checks: (a) granite-3-8b at full width, 4 of its 40 layers,
              global batch 8 x seq 2048, bf16 moments, under deterministic
              algorithms: DRY_STEPS steps with microbatch M = 1 and as many
              with M = 4 from one seeded init; the step-1 losses within
              rtol 2e-3, the parameters after one step within 2 bfloat16
              ulps of max|p| plus 2 lr, the device peak lower at M = 4;
              ms a step, tokens/s, share of the bf16 dense peak (6 N tokens
              over the step) and peak for each M; (b) a one-rank NCCL
              group and ``make_host_mesh()``: the reduced granite in
              float32 as DTensors placed by ``named(mesh, param_pspecs(...))``,
              one microbatched step (M = 2) equal to the plain-tensor step
              within 1e-5 of each leaf's largest value, and
              ``reshard_restore`` onto the mesh: DTensor leaves with the
              specs' placements, bit-equal to what was saved; (c) the dry
              run's trace of (a)'s cell on that (1, 1) mesh: counted FLOPs
              against 6 N D, the roofline's three terms (H100 datasheet
              peaks) and (a)'s measured M = 1 step over the dominant term;
              (d) ``python -m repro_torch.launch.dryrun --mesh single`` for
              gwlz-nyx vol512_g32 and granite-3-8b train_4k and decode_32k
              at full size on the 32 x 8 mesh (fake process group), three
              subprocesses at once, then ``python -m
              repro_torch.launch.roofline`` over their cells: exit 0, no
              error row, the table printed.  No kernel of ``csrc/`` is
              launched (gwlz-nyx's ``group_hist`` runs its shape rule);
13. cli     -- ``python -m repro_torch.cli`` in subprocesses on
              synthetic:temperature:64, tiled (tile 16) and monolithic,
              Lorenzo: compress -> info -> region -> decompress -> verify;
              the ROI equals the full crop, verify exits 0, and 1 on a copy
              with one byte of one lane flipped; compress --stream
              --mem-budget 1M (tile 16) -> verify, bytes equal to the tiled
              file's, and --resume without --stream (exit 2); then compress
              without --predictor (interp) -> decompress -> verify; and the
              CI serve smoke, ``serve nyx=<tiled> dm=<stream> --port 0
              --smoke``, exits 0; then the static-analysis gate, ``lint``:
              ``--json`` over the checkout's ``src/repro_torch`` in this
              process, clean under all five rules (its files and seconds
              printed), a copy of the tree with one seeded RA003 violation
              (a ``csrc`` entry no wrapper reaches) in a subprocess, exit 1
              with that one finding, and ``--rule RA999``, exit 2;
14. kernels -- each kernel again at its path's shapes: against its plain
              version, then timed (see ``kernel_ms`` and
              ``launch_events_ms``) beside the plain version, a library call
              where one exists, and the bound (the larger of bytes over
              3.35 TB/s and operations over 67 TFLOP/s; for the enhancer
              the operations this run's group ids need, see
              ``enhancer_flop``); symbol_hist and huffman_encode in the
              tiled compress's one launch over all 512 lanes; group_hist and
              enhancer_fused on both gwlz runs' decodes; symbol_hist,
              huffman_encode, huffman_decode and enhancer_fused also at the
              monolithic shapes (``mono``).  Where a parent commit's tree is
              unpacked in build/parent (``git archive``), its two Lorenzo
              kernels are built from there, checked equal to this tree's and
              timed beside them on the same inputs (``parent``);
              huffman_legacy's row is the one measured in the legacy phase;
15. cpu    -- the 128^3 corner compressed on the card and on the CPU gives
              identical bytes: GWTC Lorenzo, GWTC interp and SZJX interp;
16. golden -- tests/golden/gwtc_v1.bin and szjx_lorenzo.bin decode on the
              card bit for bit.

Each phase prints a JSON line.  Then come the ``kernels`` line, the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS reads its workspace setting when the process first uses it; the
# lm_train phase runs under deterministic algorithms, which need this one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 / int32 rate
SHAPE, TILE, REL_EB, BACKEND = (512, 512, 512), (64, 64, 64), 1e-3, "huffman+zlib"
GWLZ_EPOCHS = 1  # the paper trains 300 epochs (~1M steps at 512^3): no smoke
MONO_EPOCHS = 3  # gwlz_mono: 51 steps an epoch on 512 slices of 512x512
GWLZ_FIELDS = {"gwlz": "temperature", "gwlz_all_groups": "velocity_x"}  # phase -> field
ROI = ((100, 228), (37, 101), (300, 364))
BIG_EB = 0.5  # bigstream: integer noise on [0, 2**16), ~17.7 bits a value, > 2**31 bits
KERNELS = {  # counter name -> (source, TPU kernel it replaces, __global__ name prefix)
    "lorenzo_quant_tiles": ("src/repro_torch/csrc/lorenzo_quant.cu",
                            "src/repro/kernels/lorenzo_quant.py:87", "lorenzo_rows_kernel"),
    "lorenzo_quant": ("src/repro_torch/csrc/lorenzo_quant.cu",
                      "src/repro/kernels/lorenzo_quant.py:55", "lorenzo_rows_kernel"),
    "symbol_hist": ("src/repro_torch/csrc/symbol_hist.cu",
                    "src/repro/kernels/group_hist.py:53", "symbol_hist_lanes_kernel"),
    "huffman_encode": ("src/repro_torch/csrc/huffman_encode.cu",
                       "src/repro/kernels/huffman_encode.py:72",
                       "huffman_encode_"),  # the warp and the block form
    "huffman_decode": ("src/repro_torch/csrc/huffman_decode.cu",
                       "src/repro/kernels/huffman_decode.py:106",
                       "huffman_decode_probe_kernel"),
    # no Pallas kernel: the reference's host bit walk of a legacy stream;
    # several kernels a launch, so it is timed with CUDA events
    "huffman_legacy": ("src/repro_torch/csrc/huffman_legacy.cu",
                       "src/repro/sz/entropy.py:467 (HuffmanCodec.decode_bitwalk, host)",
                       "square_kernel"),
    "group_hist": ("src/repro_torch/csrc/group_hist.cu",
                   "src/repro/kernels/group_hist.py:73", "group_hist_kernel"),
    "enhancer_fused": ("src/repro_torch/csrc/enhancer_fused.cu",
                       "src/repro/kernels/enhancer_fused.py:68", "enhancer_grouped_kernel"),
}
GWLZ_KERNELS = ("group_hist", "enhancer_fused")  # counted on the gwlz path
LANE_KERNELS = ("symbol_hist", "huffman_encode")  # once per tiled compress, all lanes
SZJX_KERNELS = ("lorenzo_quant", "huffman_encode", "huffman_decode")  # needed on szjx
INTERP_ORDER = "cubic"  # the default predictor's order (SZCompressor, api.compress)
INTERP_KERNELS = {  # needed on the interp paths: the coarse grid's Lorenzo kernel, Huffman
    "interp": ("lorenzo_quant", "symbol_hist", "huffman_encode", "huffman_decode"),
    "interp_tiled": ("lorenzo_quant_tiles", "symbol_hist", "huffman_encode", "huffman_decode"),
}
# the path whose launches each kernel's row reports
LAUNCH_PATH = {**{k: "main" for k in KERNELS}, "lorenzo_quant": "szjx",
               "huffman_legacy": "legacy", **{k: "gwlz" for k in GWLZ_KERNELS}}
LEGACY_KERNELS = ("symbol_hist", "huffman_encode", "huffman_legacy", "huffman_decode")
SERVE_KERNELS = ("huffman_decode", "group_hist", "enhancer_fused")  # the storm's decodes
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_ROIS = 100, 3, 32  # the reference load test's floor
SERVE_BUDGET = 256 << 20  # cache and admission budget: the CLI's defaults
SERVE_WAIT_MS = 2.0  # the batcher's window: the CLI's default
STREAM_BUDGET = 256 << 20  # the reference's default compress_stream mem_budget
STREAM_EPOCHS = 5  # stream (e): the reservoir's 32 tiles, 2,048 slices of 64x64
CKPT_REL_EB = 1e-4  # checkpoint (a), lm_train (c): the reference test's bound
# gwlz_dist: steps a run; slices a step.  gwlz_nyx's global batch is 512
# and DistGWLZConfig's default 64: at 64 autograd keeps ~4 float32 copies of
# the [64, 32, 9, 512, 512] hidden values (~77 GB); at 32 the grouped conv's
# output passes 2**31 elements, past cuDNN's 32-bit indexing; 16 peaks at
# 33.8 GB (H100)
DIST_STEPS, DIST_BATCH = 5, 16
LM_ARCH, LM_LAYERS, LM_BATCH, LM_SEQ = "granite-3-8b", 4, 4, 2048  # lm_train: 4 of 40 layers
LM_STEPS, LM_EVERY, LM_FAIL, LM_LR, LM_TIMED = 20, 10, 13, 3e-4, 5
# the loop's moments: int8 diverges within a dozen steps in both packages
# (tests/test_torch_lm.py), so it is timed alone for LM_TIMED steps
LM_MOMENTS = "bf16"
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16
# lm_serve (a): gemma3-1b at full depth through the serving driver
# prompt 512 and 128 generated (cut from 1,024 and 256 to make room for the
# dryrun phase); 639 steps still wrap the 512-slot rings
SERVE_ARCH, SERVE_BATCH, SERVE_CTX, SERVE_PROMPT, SERVE_GEN = "gemma3-1b", 8, 2048, 512, 128
# (b): 1,024 positions are two 512-query blocks, so the sliding layers'
# prefill is banded (640 would be one block, unbanded); one 5:1 period of
# layers keeps the 1,024 sequential decode steps inside the time limit
SERVE_PREFILL, SERVE_PREFILL_LAYERS = 1024, 6
SERVE_MOE = (("llama4-scout-17b-a16e", 4), ("deepseek-v3-671b", 4))  # (c): arch, layers kept
SERVE_MOE_BATCH, SERVE_MOE_PROMPT, SERVE_MOE_GEN, SERVE_MOE_CTX = 4, 16, 49, 1024  # 64 steps
SERVE_CPU_STEPS = 12  # (d)
# lm_families: (a)-(d) each arch at full width and depth through the serving
# driver, bf16, batch 8: (arch, ctx, prompt, generated); rwkv6 keeps no
# cache that grows, and 448 is whisper's decoder context
FAM_BATCH = 8
FAM_SERVE = (("zamba2-1.2b", 2048, 128, 128), ("rwkv6-7b", 128, 64, 64),
             ("qwen2-vl-7b", 2048, 128, 128), ("whisper-small", 448, 4, 128))
FAM_ARCHS = tuple(arch for arch, *_ in FAM_SERVE)
# (e): positions, and the depth kept (zamba2: one period of 6; whisper: 2 + 2)
FAM_PREFILL = 128
FAM_PREFILL_LAYERS = {"rwkv6-7b": 2, "zamba2-1.2b": 6, "qwen2-vl-7b": 2, "whisper-small": 2}
FAM_CPU_STEPS = 12  # (f)
FAM_TRAIN = ("whisper-small", "qwen2-vl-7b", "zamba2-1.2b")  # (g): the trained drivers
PROFILED = 4  # (a): decode steps in the torch.profiler window, a step reported
# dryrun (a): granite at lm_train's cut, the global batch 8 x 2048 (M = 1, 4)
DRY_BATCH, DRY_MICRO, DRY_STEPS = 8, (1, 4), 3
DRY_CELLS = (("gwlz-nyx", "vol512_g32"), ("granite-3-8b", "train_4k"),
             ("granite-3-8b", "decode_32k"))  # (d): full size on the 32 x 8 mesh
LOOP_STEPS, LOOP_EVERY, LOOP_FAILS = 40, 10, (17, 31)  # checkpoint (b): the reference test's
ENHANCE_RTOL = 1e-5  # |kernel - plain| <= ENHANCE_RTOL * (1 + max|plain|)
# a parent commit's tree, unpacked with git archive: its Lorenzo kernels are
# timed beside this tree's in the same run when it is there
PARENT = ROOT / "build" / "parent"
PARENT_LORENZO = {"lorenzo_quant_tiles": "lorenzo_quant_tiles_kernel",  # name -> its __global__
                  "lorenzo_quant": "lorenzo_quant_volume_kernel"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a, b) -> int:
    """Largest integer difference of two int32 results (0 = bit-exact)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def events_ms(fn, reps: int) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls, over
    ``reps``.  The calls are queued behind a device-side sleep longer than
    their enqueue, so the host's launch cost is hidden unless a call
    synchronizes inside (then its host time counts, as its caller pays it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * enqueue_s * 2e9))  # cycles; the clock is <= 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def launch_events_ms(fn, reps: int) -> tuple[float, str]:
    """Device time of one launch: a pair of CUDA events around each of
    ``reps`` calls, all queued behind a device-side sleep so no host gap
    falls inside a pair; the mean interval.  For calls of one long launch,
    where the wrapper's own work is a rounding error.  Returns (ms, method)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(int(1.5 * reps * one_s * 2e9))  # cycles; the clock is <= 2 GHz
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    pairs[-1][1].synchronize()
    return (sum(a.elapsed_time(b) for a, b in pairs) / reps,
            f"events, 1 launch per interval, {reps} intervals")


def kernel_ms(fn, kernel: str, reps: int, traces: int = 3) -> tuple[float, str]:
    """Device time of the kernel alone: its own intervals in a torch.profiler
    trace of ``reps`` calls, over their launches, so the wrapper's host work
    and output allocation are left out.

    The profiler keeps only the device activity that falls inside its
    capture window, and it takes the window's ends from the host's clock: a
    launch that starts as the window opens, or ends as it closes, can be
    dropped when the device's clock runs apart from the host's.  So each
    trace follows a warm-up step whose events are dropped, its calls are
    queued behind a device-side sleep of at least 20 ms, and the window
    closes 20 ms after the last launch has finished.  Only a trace that
    holds every launch counts: one that lost launches is taken again, up to
    ``traces`` in all.  If every trace lost launches, or the profiler
    records no device time, the kernel is timed with CUDA events around each
    call instead (:func:`launch_events_ms`: the wrapper's own device work,
    such as zeroing a histogram, counts then), and the method says so.
    Returns (ms, method)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    lead_cycles = int(max(0.02, 1.5 * (time.perf_counter() - t0)) * 2e9)  # clock <= 2 GHz
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lost = []
    for _ in range(traces):
        warm_then_trace = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=warm_then_trace) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(lead_cycles)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
                and e.self_device_time_total > 0]
        count = sum(e.count for e in hits)
        if count == 0:
            lost.append("no device time")
            break
        if count == reps:
            return (sum(e.self_device_time_total for e in hits) / count / 1e3,
                    f"profiler {count}/{reps}"
                    + (f" (earlier traces held {lost})" if lost else ""))
        lost.append(f"{count}/{reps}")
    ms, how = launch_events_ms(fn, reps)
    return ms, f"{how} (profiler traces held {lost})"


class Parity:
    """Runs kernel-vs-plain comparisons and keeps each kernel's worst error
    (and, for float kernels, the tolerance it was held to)."""

    def __init__(self):
        self.err = {name: 0 for name in KERNELS}
        self.cases = {name: 0 for name in KERNELS}
        self.tol = {name: 0 for name in KERNELS}

    def compare(self, name: str, case: str, got, want) -> None:
        import torch

        torch.cuda.synchronize()  # a fault during the kernel surfaces here
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(max_abs_err(g, w) for g, w in pairs)
        self.err[name] = max(self.err[name], err)
        self.cases[name] += 1
        check(err == 0, f"{name} [{case}] differs from its plain version by {err}")

    def compare_float(self, name: str, case: str, got, want, rtol: float) -> None:
        """|got - want| <= rtol (1 + max|want|), both finite."""
        import torch

        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name} [{case}] shape {tuple(got.shape)} != "
              f"{tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
              f"{name} [{case}] has non-finite values")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        tol = rtol * (1 + (float(want.abs().max()) if want.numel() else 0.0))
        self.err[name] = max(self.err[name], err)
        self.tol[name] = max(self.tol[name], tol)
        self.cases[name] += 1
        check(err <= tol, f"{name} [{case}] differs from its plain version by {err} > {tol}")


def edge_parity(par: Parity) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import enhancer_fused, group_hist, huffman_decode
    from repro_torch.kernels import huffman_encode, lorenzo_quant, ref
    from repro_torch.sz import entropy

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # lorenzo: .5 ties, negatives, |q| near 2**25 and 2**31 (the int32
    # differences wrap), X % 4 of 1-3, tiles and rows off 16 bytes (5x13x37,
    # X = 66, a base 4 bytes past an aligned one), X = 1, Z = 1, ranks 1-3:
    # the tile kernel on each batch, the volume kernel on its first tile
    eb = 0.75
    two = float(np.float32(eb) * 2)

    def lorenzo_x(kind: str, shape) -> np.ndarray:
        if kind == "ties":
            return np.asarray((rng.integers(-4000, 4000, shape) + 0.5) * two, np.float32)
        if kind.startswith("q_"):  # q_<bits>: |q| up to 0.999 * 2**bits
            bits = int(kind[2:])
            return np.asarray(rng.uniform(-1, 1, shape) * 0.999 * 2**bits * two, np.float32)
        return np.asarray(rng.normal(0, 50, shape), np.float32)

    def on_card(x: np.ndarray, off: bool):
        if not off:
            return torch.from_numpy(x).to(dev)
        t = torch.empty(x.size + 1, dtype=torch.float32, device=dev)[1:].view(x.shape)
        return t.copy_(torch.from_numpy(x))

    for case, (kind, shape) in {
        "ties_negatives_ragged_5x13x37": ("ties", (3, 5, 13, 37)),
        "q_near_2^25": ("q_25", (2, 9, 40, 33)),
        "q_near_2^31_x132": ("q_31", (2, 9, 40, 132)),
        "q_near_2^31_x64": ("q_31", (3, 8, 8, 64)),
        "x_mod4_1": ("normal", (2, 5, 9, 129)),
        "x_mod4_2": ("normal", (2, 5, 9, 130)),
        "x_mod4_3": ("normal", (2, 5, 9, 131)),
        "x66_rows_off_16B": ("ties", (4, 5, 13, 66)),
        "base_off_16B": ("ties", (2, 4, 8, 512)),
        "x1": ("normal", (3, 4, 7, 1)),
        "z1": ("normal", (3, 1, 7, 200)),
        "z1_y1_x1": ("normal", (5, 1, 1, 1)),
        "rank1": ("normal", (4, 70)),
        "rank2": ("normal", (4, 17, 45)),
        "tile_64^3": ("normal", (3, 64, 64, 64)),
    }.items():
        xt = on_card(lorenzo_x(kind, shape), case == "base_off_16B")
        par.compare("lorenzo_quant_tiles", case, lorenzo_quant.lorenzo_quant_tiles(xt, eb),
                    ref.lorenzo_quant_tiles_ref(xt, eb))
        par.compare("lorenzo_quant", case, lorenzo_quant.lorenzo_quant(xt[0], eb),
                    ref.lorenzo_quant_ref(xt[0], eb))
    # the volume kernel: Z across its 32-plane segments at each vector width
    # (X = 128: 4 cells a lane, 66: 2, 45 and 37: 1), and rank 0
    for case, (kind, shape) in {
        "z33_segments": ("normal", (33, 17, 45)),
        "z64_x70": ("normal", (64, 9, 70)),
        "z70_x128_ties": ("ties", (70, 9, 128)),
        "z65_x66_q_near_2^31": ("q_31", (65, 5, 66)),
        "z31_x512_q_near_2^31": ("q_31", (31, 3, 512)),
        "z65_x37_ties": ("ties", (65, 3, 37)),
        "rank0": ("ties", ()),
    }.items():
        xt = on_card(lorenzo_x(kind, shape), False)
        par.compare("lorenzo_quant", case, lorenzo_quant.lorenzo_quant(xt, eb),
                    ref.lorenzo_quant_ref(xt, eb))

    # symbol_hist: shared-memory bins, a span above 4096, global-atomic bins,
    # out-of-range values
    for case, (lo, hi, bins, n) in {
        "span_300": (0, 300, 300, 262144),
        "span_5000_out_of_range": (-50, 5100, 5000, 100003),
        "span_200000_global": (0, 200000, 200000, 300001),
    }.items():
        s = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)
        par.compare("symbol_hist", case, group_hist.symbol_hist(s, bins),
                    ref.symbol_hist_ref(s, bins))

    # the lane histogram: one row spread over the card and 512 rows of a
    # block each, lanes piled on one bin, spans at the shared-memory limit,
    # just past it and above 2**16, rows off a 16-byte boundary
    for case, (L, n, span) in {
        "lanes_L1": (1, 1_000_003, 994), "lanes_L512": (512, 4096, 62),
        "lanes_skewed": (64, 65536, 300),
        f"lanes_span_{group_hist.SMEM_BINS}": (8, 100_000, group_hist.SMEM_BINS),
        f"lanes_span_{group_hist.SMEM_BINS + 1}": (8, 100_000, group_hist.SMEM_BINS + 1),
        "lanes_span_70000": (4, 300_001, 70_000),
        "lanes_rows_off_16B": (33, 4099, 500),
    }.items():
        lo = rng.integers(-1000, 1000, L).astype(np.int32)
        c = lo[:, None] + rng.integers(-3, span + 3, (L, n)).astype(np.int32)
        if case == "lanes_skewed":  # 97% of every lane on one bin
            c = np.where(rng.random((L, n)) < 0.97, lo[:, None] + 5,
                         lo[:, None] + rng.integers(0, 2, (L, n))).astype(np.int32)
        ct, lt = torch.from_numpy(c).to(dev), torch.from_numpy(lo).to(dev)
        par.compare("symbol_hist", case, group_hist.symbol_hist_lanes(ct, lt, span),
                    ref.symbol_hist_lanes_ref(ct, lt, span))
        del ct, c

    # Huffman: codes longer than the 12-bit LUT (escape path) and a skew that
    # hits the 32-bit length cap; short last chunks; chunk sizes 8..1000
    sizes_esc = [2 ** i for i in range(16, 0, -1)] + [1, 1]
    fib = [1, 1] + [2 ** i for i in range(1, 45)]
    for case, (sizes, cs) in {
        "escape_cs256": (sizes_esc, 256),
        "max_codeword_cs64": (fib, 64),
        "escape_cs1000": (sizes_esc, 1000),
        "short_chunk_cs8": ([5, 3, 1], 8),
    }.items():
        counts = np.minimum(np.asarray(sizes, np.int64), 4096)  # keep the stream small
        sym = np.repeat(np.arange(len(sizes), dtype=np.int32), counts)
        rng.shuffle(sym)
        # put the longest code (the last symbol) at the very end too
        sym = np.concatenate([sym, [len(sizes) - 1]]).astype(np.int32)
        flat = torch.from_numpy(sym).to(dev)
        codec = entropy.HuffmanCodec.fit(flat)
        if case == "max_codeword_cs64":  # lengths of the uncapped skew: up to 32 bits
            L = entropy._limited_code_lengths(np.asarray(sizes, np.int64))
            codec = entropy.HuffmanCodec(codec.alphabet, L, entropy._canonical_codes(L))
            check(int(L.max()) == 32, "max-codeword case needs 32-bit codes")
        lens, cws = codec._pack_inputs(flat, cs)
        words, bits = huffman_encode.huffman_encode_pack(lens, cws)
        par.compare("huffman_encode", case, (words, bits), ref.huffman_encode_ref(lens, cws))
        local = words[:, : -(-int(bits.max()) // 32)].contiguous().cpu().numpy().view(np.uint32)
        bits64 = bits.cpu().numpy().astype(np.int64)
        stream, _ = entropy._splice_chunks(local, bits64)
        args, kw = codec._decode_inputs(stream, sym.size, cs,
                                        np.cumsum(bits64) - bits64, dev)
        ids = huffman_decode.huffman_decode_probe(*args, **kw)
        par.compare("huffman_decode", case, ids, ref.huffman_decode_ref(*args, **kw))
        got = torch.from_numpy(codec.alphabet).to(dev)[ids.reshape(-1)[: sym.size]]
        check(torch.equal(got, flat), f"huffman round trip [{case}] lost symbols")

    # encode and decode at chunk sizes 1 and MAX_CHUNK (a chunk past 48 KB
    # of the encode's shared memory in all; it overruns its decode warp's
    # staged words), 32-bit codes and LUT escapes among one warp's chunks, an
    # alphabet past the shared-memory escape tables; the decode alone with
    # int32 offsets and on a zeroed or truncated stream, which must still end
    skew = np.repeat(np.arange(17, dtype=np.int32),
                     np.minimum([2 ** i for i in range(15, 0, -1)] + [1, 1], 4096))
    rng.shuffle(skew)
    skew_codec = entropy.HuffmanCodec.fit(torch.from_numpy(skew))
    L32 = entropy._limited_code_lengths(np.asarray(fib, np.int64))
    codec32 = entropy.HuffmanCodec(np.arange(L32.size, dtype=np.int32), L32,
                                   entropy._canonical_codes(L32))
    # the encode in both of its forms (a warp a chunk up to WARP_MAX_CS, a
    # block a chunk above), pad slots in the last chunk, 32-bit codes among
    # short ones, and rows off a 16-byte boundary (scalar loads)
    for cs in (1, 31, 255, 256, 257, huffman_encode.WARP_MAX_CS, huffman_encode.MAX_CHUNK):
        sym32 = rng.choice(np.arange(6, dtype=np.int32), 3 * cs * 9 + 5)
        sym32[::37] = L32.size - 1
        lens, cws = codec32._pack_inputs(torch.from_numpy(sym32).to(dev), cs)
        par.compare("huffman_encode", f"cs{cs}_pad_codes32",
                    huffman_encode.huffman_encode_pack(lens, cws), ref.huffman_encode_ref(lens, cws))
        C = lens.shape[0]
        lens, cws = (t.reshape(-1)[1 : 1 + (C - 1) * cs].view(C - 1, cs) for t in (lens, cws))
        par.compare("huffman_encode", f"cs{cs}_rows_off_16B",
                    huffman_encode.huffman_encode_pack(lens, cws), ref.huffman_encode_ref(lens, cws))
    mixed = rng.choice(np.arange(8, dtype=np.int32), 64 * 40)
    mixed[::97], mixed[5::61] = L32.size - 1, L32.size - 3
    wide = rng.integers(0, 70000, 300001).astype(np.int32)
    for case, (codec, sym, cs, damage) in {
        "cs1": (skew_codec, skew[:3001], 1, None),
        "cs256_int32_offsets": (skew_codec, skew, 256, "int32"),
        f"cs{huffman_encode.MAX_CHUNK}": (skew_codec, np.concatenate([skew, skew[:777]]),
                                          huffman_encode.MAX_CHUNK, None),
        "codes32_and_escapes_in_a_warp": (codec32, mixed, 40, None),
        "short_last_chunk": (skew_codec, skew[: 256 * 37 + 3], 256, None),
        "wide_alphabet": (None, wide, 256, None),
        "zeroed_stream": (skew_codec, skew, 256, "zero"),
        "truncated_stream": (skew_codec, skew, 256, "truncate"),
    }.items():
        codec = codec or entropy.HuffmanCodec.fit(torch.from_numpy(sym))
        stream, bits64, _ = codec._device_pack(torch.from_numpy(sym).to(dev), cs)
        plain = codec._device_pack(torch.from_numpy(sym), cs)[:2]  # the plain encode
        par.compare("huffman_encode", case,
                    (torch.frombuffer(bytearray(stream), dtype=torch.uint8),
                     torch.from_numpy(bits64)),
                    (torch.frombuffer(bytearray(plain[0]), dtype=torch.uint8),
                     torch.from_numpy(plain[1])))
        args, kw = codec._decode_inputs(stream, sym.size, cs, np.cumsum(bits64) - bits64, dev)
        args = list(args)
        if damage == "int32":
            args[1] = args[1].to(torch.int32)
        elif damage == "zero":
            args[0] = torch.zeros_like(args[0])
        elif damage == "truncate":
            args[0] = args[0][: args[0].numel() // 3].clone()
            args[0][-2:] = 0
        ids = huffman_decode.huffman_decode_probe(*args, **kw)
        par.compare("huffman_decode", case, ids, ref.huffman_decode_ref(*args, **kw))
        if damage in (None, "int32"):
            check(np.array_equal(codec.alphabet[ids.reshape(-1)[: sym.size].cpu().numpy()],
                                 sym), f"huffman decode [{case}] lost symbols")

    # group_hist: values on every edge, below the first and above the last,
    # duplicate edges, G = 1, 20 and the largest G, sizes off the block
    for case, (G, n) in {"G1": (1, 1000), "G20_dup_edges": (20, 262147),
                         "G20_ragged": (20, 77), f"G{group_hist.MAX_GROUPS}":
                         (group_hist.MAX_GROUPS, 100003)}.items():
        edges = np.sort(rng.normal(0, 1, G + 1)).astype(np.float32)
        if G > 4:
            edges[3:5] = edges[2]
        vals = np.concatenate([edges, [edges[0] - 1, edges[-1] + 1, -np.inf, np.inf],
                               rng.normal(0, 1.5, n)]).astype(np.float32)
        xt, et = torch.from_numpy(vals).to(dev), torch.from_numpy(edges).to(dev)
        par.compare("group_hist", case, group_hist.group_hist(xt, et),
                    ref.group_hist_ref(xt, et))

    # enhancer_fused: the TPU kernel's G = 1 contract on assorted shapes, then
    # the grouped form with ids changing inside every halo
    C = 9

    def f(*shape, scale=0.5):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    p1 = {"w1": f(3, 3, 1, C), "b1": f(C), "gamma": f(C) + 1, "beta": f(C),
          "w2": f(3, 3, C, 1), "b2": f(1)}
    s1 = {"mean": f(C), "var": f(C).abs() + 0.5}
    order = ("w1", "b1", "gamma", "beta")
    for shape in [(2, 1, 1), (3, 3, 100), (2, 17, 45), (2, 64, 64)]:
        xt = f(*shape, scale=1.0)
        single = enhancer_fused.single_enhancer(*(p1[k] for k in order), s1["mean"],
                                                s1["var"], p1["w2"], p1["b2"])
        got = enhancer_fused.enhancer_grouped(xt, None, single, mode="pred")
        want = ref.enhancer_fused_ref(xt, *(p1[k] for k in order), s1["mean"], s1["var"],
                                      p1["w2"], p1["b2"])
        par.compare_float("enhancer_fused", f"G1_{shape[1]}x{shape[2]}", got, want,
                          ENHANCE_RTOL)
    G = 20
    lo = torch.from_numpy(np.sort(rng.normal(0, 1, G)).astype(np.float32)).to(dev)
    rscale = f(G).abs() + 0.01
    rscale[3] = 0.0  # an inactive group
    packed = enhancer_fused.pack_enhancers(lo, f(G).abs() + 0.1, f(G), rscale, f(G, 9, C), f(G, C),
                                f(G, C).abs() + 0.5, f(G, C), f(G, 9, C))
    xt = f(4, 50, 70, scale=1.0)
    ids = torch.from_numpy(rng.integers(0, G, xt.shape).astype(np.int32)).to(dev)
    for case, mode, clamp in [("grouped_pred", "pred", None),
                              ("grouped_residual_inactive", "residual", None),
                              ("grouped_clamp", "residual", 0.01),
                              ("grouped_direct", "direct", None)]:
        got = enhancer_fused.enhancer_grouped(xt, ids, packed, mode=mode, clamp_eb=clamp)
        want = ref.enhancer_grouped_ref(xt, ids, packed, mode=mode, clamp_eb=clamp)
        par.compare_float("enhancer_fused", case, got, want, ENHANCE_RTOL)
        if mode == "residual":
            check(torch.equal(got[ids == 3], xt[ids == 3]), "an inactive group changed x")
        if clamp is not None:
            check(bool(((got - xt).abs() <= clamp + 1e-6).all()), "the clamp let a value out")
    # the grouped kernel on the edges of its design: 9 groups in one 3x3
    # neighbourhood, all 20 in one block, groups changing on block and halo
    # borders, H or W of 1, sizes off the 32-wide block, G = 287 and the
    # launcher's maximum; each also bit for bit against a launch on a subset
    # of the slices
    for case, (G, shape) in {"nine_groups_a_neighbourhood": (9, (2, 40, 70)),
                             "twenty_groups_a_block": (20, (3, 32, 32)),
                             "groups_change_on_block_borders": (4, (2, 70, 90)),
                             "height_1": (3, (4, 1, 77)), "width_1": (3, (4, 77, 1)),
                             "off_block_sizes": (5, (3, 45, 33)), "G287": (287, (2, 64, 96)),
                             f"G{enhancer_fused.MAX_GROUPS}":
                             (enhancer_fused.MAX_GROUPS, (2, 64, 64))}.items():
        yy, xx = np.meshgrid(np.arange(shape[1]), np.arange(shape[2]), indexing="ij")
        if case == "nine_groups_a_neighbourhood":
            g_np = np.broadcast_to((yy % 3) * 3 + xx % 3, shape)
        elif case == "groups_change_on_block_borders":
            g_np = np.broadcast_to((xx // 32 + yy // 32 + (xx % 32 == 31)) % G, shape)
        else:
            g_np = rng.integers(0, G, shape)
        gt = torch.from_numpy(np.ascontiguousarray(g_np, np.int32)).to(dev)
        if case == "twenty_groups_a_block":
            check(torch.unique(gt[0]).numel() == 20, "a block must hold all 20 groups")
        rs = f(G).abs() + 0.01
        rs[0] = 0.0
        pk = enhancer_fused.pack_enhancers(
            torch.from_numpy(np.sort(rng.normal(0, 1, G)).astype(np.float32)).to(dev),
            f(G).abs() + 0.1, f(G), rs, f(G, 9, C), f(G, C), f(G, C).abs() + 0.5, f(G, C),
            f(G, 9, C))
        xt = f(*shape, scale=1.0)
        for mode in ("pred", "residual"):
            got = enhancer_fused.enhancer_grouped(xt, gt, pk, mode=mode)
            par.compare_float("enhancer_fused", f"{case}_{mode}", got,
                              ref.enhancer_grouped_ref(xt, gt, pk, mode=mode), ENHANCE_RTOL)
            check(torch.equal(enhancer_fused.enhancer_grouped(xt[1:], gt[1:], pk, mode=mode),
                              got[1:]), f"enhancer_fused [{case}] differs on a subset")
    emit({"phase": "edges", "cases": par.cases, "max_abs_err": par.err,
          "float_tolerance": {k: v for k, v in par.tol.items() if v}})


def main_path(x_np):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sz import TiledCompressed, compress_tiled, decompress_region
    from repro_torch.sz import decompress_tiled

    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art, recon = compress_tiled(x_np, TILE, rel_eb=REL_EB, backend=BACKEND)
    blob = art.to_bytes()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    compress_launches = dict(ops.LAUNCHES)
    back = TiledCompressed.from_bytes(blob)
    out = decompress_tiled(back)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    region = decompress_region(back, ROI)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).to(out.device)
    check(tuple(out.shape) == SHAPE and out.dtype == torch.float32, "decode shape/dtype")
    check(bool(torch.isfinite(out).all()), "non-finite values in the decode")
    err = float((x.double() - out.double()).abs().max())
    check(err <= art.eb_abs * (1 + 1e-6), f"error {err} above eb {art.eb_abs}")
    check(torch.equal(out, recon), "decode differs from the compress-time reconstruction")
    crop = out[tuple(slice(a, b) for a, b in ROI)]
    check(torch.equal(region, crop), "region decode differs from the full decode's crop")
    check(all(launches[k] > 0 for k in KERNELS if LAUNCH_PATH[k] == "main"),
          f"a kernel never launched: {launches}")
    check(all(compress_launches[k] == 1 for k in LANE_KERNELS),
          f"the tiled compress did not launch each lane kernel once: {compress_launches}")
    emit({"phase": "main", "shape": list(SHAPE), "tile": list(TILE), "rel_eb": REL_EB,
          "backend": BACKEND, "eb_abs": art.eb_abs, "compress_s": t1 - t0,
          "decompress_s": t2 - t1, "region_ms": (t3 - t2) * 1e3, "roi": [list(r) for r in ROI],
          "region_tiles": int(np.prod([-(-b // t) - a // t for (a, b), t in zip(ROI, TILE)])),
          "ratio": x_np.nbytes / len(blob), "container_bytes": len(blob),
          "compress_device_peak_bytes": peak,
          "max_abs_err": err, "compress_launches": compress_launches, "launches": launches})
    return art, container_id(blob, t1 - t0, peak), launches


def container_id(blob: bytes, compress_s: float, peak: int) -> dict:
    """What the stream phase holds an eager container to: its sha256 and
    size, and the eager compress's seconds and device peak."""
    import hashlib

    return {"sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob),
            "compress_s": compress_s, "device_peak_bytes": peak}


def gwlz_path(x_np, phase: str):
    """The enhancer path: GWLZ compress (SZ, training, calibration, gate,
    enhancement), container round trip, enhanced full and region decode."""
    import numpy as np
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GWLZ, GWLZTrainConfig, deserialize_model
    from repro_torch.kernels import ops
    from repro_torch.sz import TiledCompressed

    cfg = GWLZTrainConfig(epochs=GWLZ_EPOCHS)
    gw = GWLZ(train_cfg=cfg)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art, stats = gw.compress_tiled(x_np, TILE, rel_eb=REL_EB, predictor="lorenzo")
    blob = art.to_bytes()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    compress_launches = dict(ops.LAUNCHES)
    back = TiledCompressed.from_bytes(blob)
    out = gw.decompress_tiled(back)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    region = gw.decompress_region(back, ROI)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).to(out.device)
    check(tuple(out.shape) == SHAPE and bool(torch.isfinite(out).all()), "gwlz decode shape")
    psnr = float(metrics.psnr(x, out))
    check(psnr == stats.psnr_gwlz, f"decode PSNR {psnr} != compress-time {stats.psnr_gwlz}")
    crop = out[tuple(slice(a, b) for a, b in ROI)]
    check(torch.equal(region, crop), "enhanced region differs from the full decode's crop")
    check(stats.psnr_gwlz >= stats.psnr_sz - 1e-3,
          f"enhancement lost PSNR: {stats.psnr_sz} -> {stats.psnr_gwlz}")
    check(all(launches[k] > 0 for k in GWLZ_KERNELS), f"an enhancer kernel never ran: {launches}")
    check(all(compress_launches[k] == 1 for k in LANE_KERNELS),
          f"the GWLZ compress did not launch each lane kernel once: {compress_launches}")
    model = deserialize_model(art.extras["gwlz"])
    trained = int((np.asarray(stats.loss_history[-1]) > 0).sum())  # groups holding values
    if phase == "gwlz_all_groups":
        check(trained == cfg.n_groups, f"only {trained} of {cfg.n_groups} groups trained")
    sec = stats.seconds
    steps = (np.prod(SHAPE) // (TILE[1] * TILE[2])) // cfg.batch_size * cfg.epochs
    emit({"phase": phase, "field": GWLZ_FIELDS[phase], "shape": list(SHAPE),
          "tile": list(TILE), "rel_eb": REL_EB,
          "n_groups": cfg.n_groups, "channels": cfg.channels, "batch_size": cfg.batch_size,
          "epochs": cfg.epochs, "steps": int(steps), "compress_s": t1 - t0,
          "seconds": sec, "train_ms_per_step": 1e3 * sec["train"] / steps,
          "decompress_s": t2 - t1, "region_ms": (t3 - t2) * 1e3,
          "psnr_sz": stats.psnr_sz, "psnr_gwlz": stats.psnr_gwlz, "psnr_decode": psnr,
          "overhead": stats.overhead, "ratio_sz": stats.cr_sz, "ratio_gwlz": stats.cr_gwlz,
          "max_err_sz": stats.max_err_sz, "max_err_gwlz": stats.max_err_gwlz,
          "model_params": stats.n_model_params,
          "trained_groups": trained, "active_groups": int((model.rscale > 0).sum()),
          "distinct_edges": int(torch.unique(model.edges).numel()),
          "loss_epoch0": [round(float(v), 6) for v in stats.loss_history[0]],
          "compress_launches": compress_launches, "launches": launches})
    return art, model, launches


def roi_key():
    return tuple(slice(a, b) for a, b in ROI)


def szjx_path(x_np, tmp: Path):
    """The monolithic SZ path through the façade: compress, save, open, full
    decode and the main ROI."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.sz import SZCompressor

    path = tmp / "field.szjx"
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = api.compress(x_np, eb=REL_EB, predictor="lorenzo", backend=BACKEND)
    n = api.save(path, vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with api.open(path) as back:
        full = np.asarray(back)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        region = back[roi_key()]
        t3 = time.perf_counter()
        art = back.artifact
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).cuda()
    eb = art.eb_abs
    out = torch.from_numpy(full.copy()).cuda()
    check(full.shape == SHAPE and bool(torch.isfinite(out).all()), "szjx decode shape")
    err = float((x.double() - out.double()).abs().max())
    check(err <= eb * (1 + 1e-6), f"szjx error {err} above eb {eb}")
    # the compress-time reconstruction, from the compressor itself (after
    # the counters were read); compress is deterministic
    again, recon = SZCompressor("lorenzo", backend=BACKEND).compress(x, rel_eb=REL_EB)
    check(again.to_bytes() == path.read_bytes(), "szjx compress is not deterministic")
    check(torch.equal(out, recon), "szjx decode differs from the compress-time reconstruction")
    del again, recon
    check(np.array_equal(region, full[roi_key()]), "szjx slice differs from the full crop")
    check(all(launches[k] > 0 for k in SZJX_KERNELS), f"a szjx kernel never launched: {launches}")
    corner = np.ascontiguousarray(x_np[:128, :128, :128])
    card = SZCompressor("lorenzo", backend=BACKEND).compress(corner, rel_eb=REL_EB)[0]
    cpu = SZCompressor("lorenzo", backend=BACKEND).compress(corner, rel_eb=REL_EB,
                                                            device="cpu")[0]
    check(card.to_bytes() == cpu.to_bytes(), "card and CPU SZJX bytes differ on the corner")
    emit({"phase": "szjx", "shape": list(SHAPE), "rel_eb": REL_EB, "backend": BACKEND,
          "eb_abs": eb, "compress_s": t1 - t0, "decompress_s": t2 - t1,
          "region_ms": (t3 - t2) * 1e3, "roi": [list(r) for r in ROI], "ratio": x_np.nbytes / n,
          "container_bytes": n, "max_abs_err": err, "corner_bytes_identical": True,
          "symbols": int(np.prod(SHAPE)), "launches": launches})
    return art, launches


def interp_sweeps(xp, eb: float, levels: int) -> tuple:
    """The interp predictor's sweeps (torch ops, no kernel of their own) on
    a batch of padded volumes [B, *pshape]: one encode with straggler
    promotion (its rounds and outliers, and the decoder's reconstruction),
    then the device time of one encode and of one decode (CUDA events, 3
    calls each).  Returns (reconstruction, stats)."""
    from repro_torch.sz import predictor as P

    codes, omask, ovals, recon, rounds = P.interp_encode_batch(xp, eb, levels, INTERP_ORDER)
    stats = {"batch": list(xp.shape), "levels": levels, "straggler_rounds": rounds,
             "outliers": int(omask.sum()),
             "encode_ms": events_ms(lambda: P._interp_encode_padded(xp, eb, levels,
                                                                    INTERP_ORDER), 3),
             "decode_ms": events_ms(lambda: P._interp_decode_padded(
                 codes, omask, ovals, eb, levels, INTERP_ORDER), 3)}
    return recon, stats


def interp_path(x_np, tmp: Path):
    """The default SZ path (interp, cubic: one stream of the padded volume's
    codes) through the façade: compress, save, open (mmap), full decode and
    the main ROI."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.sz import predictor as P

    path = tmp / "field_interp.szjx"
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = api.compress(x_np, eb=REL_EB, backend=BACKEND)
    n = api.save(path, vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del vol
    with api.open(path) as back:
        full = np.asarray(back)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        region = back[roi_key()]
        t3 = time.perf_counter()
        art = back.artifact
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).cuda()
    out = torch.from_numpy(full.copy()).cuda()
    check(full.shape == SHAPE and bool(torch.isfinite(out).all()), "interp decode shape")
    check(art.predictor == "interp" and art.order == INTERP_ORDER, "not the default predictor")
    eb32 = float(np.float32(art.eb_abs))
    err = float((x.double() - out.double()).abs().max())
    check(err <= eb32, f"interp error {err} above eb {eb32}")
    # the compress-time reconstruction: the encode again, on the same padded
    # volume (compress is deterministic), with its straggler rounds
    xp = P.pad_edge(x, tuple(art.padded_shape))[None]
    recon, sweeps = interp_sweeps(xp, art.eb_abs, art.levels)
    del xp
    check(torch.equal(out, recon[0][tuple(slice(0, d) for d in SHAPE)]),
          "interp decode differs from the compress-time reconstruction")
    del recon
    check(sweeps["outliers"] == art.outlier_idx.size, "interp outliers differ between runs")
    check(np.array_equal(region, full[roi_key()]), "interp slice differs from the full crop")
    check(all(launches[k] > 0 for k in INTERP_KERNELS["interp"]),
          f"an interp kernel never launched: {launches}")
    emit({"phase": "interp", "shape": list(SHAPE), "rel_eb": REL_EB, "backend": BACKEND,
          "order": art.order, "levels": art.levels, "padded_shape": list(art.padded_shape),
          "eb_abs": art.eb_abs, "compress_s": t1 - t0, "decompress_s": t2 - t1,
          "region_ms": (t3 - t2) * 1e3, "roi": [list(r) for r in ROI], "ratio": x_np.nbytes / n,
          "container_bytes": n, "max_abs_err": err, "max_err_over_eb": err / eb32,
          "outliers": int(art.outlier_idx.size), "symbols": int(np.prod(art.padded_shape)),
          "decode_equals_recon": True, "roi_equals_crop": True, "sweeps": sweeps,
          "launches": launches})
    return launches


def interp_tiled_path(x_np):
    """Tiled interp: compress_tiled(predictor="interp") over 64^3 tiles (65^3
    padded, one lane each), container round trip, full decode and the
    region read."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sz import TiledCompressed, compress_tiled, decompress_region
    from repro_torch.sz import decompress_tiled, tiled
    from repro_torch.sz import predictor as P

    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art, recon = compress_tiled(x_np, TILE, rel_eb=REL_EB, backend=BACKEND, predictor="interp")
    blob = art.to_bytes()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    compress_launches = dict(ops.LAUNCHES)
    back = TiledCompressed.from_bytes(blob)
    out = decompress_tiled(back)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    region = decompress_region(back, ROI)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).to(out.device)
    check(tuple(out.shape) == SHAPE and bool(torch.isfinite(out).all()), "interp_tiled shape")
    eb32 = float(np.float32(art.eb_abs))
    err = float((x.double() - out.double()).abs().max())
    check(err <= eb32, f"interp_tiled error {err} above eb {eb32}")
    check(torch.equal(out, recon), "interp_tiled decode differs from the compress-time "
          "reconstruction")
    crop = out[tuple(slice(a, b) for a, b in ROI)]
    check(torch.equal(region, crop), "interp_tiled region differs from the full crop")
    del recon, out, region, crop
    check(all(launches[k] > 0 for k in INTERP_KERNELS["interp_tiled"]),
          f"an interp_tiled kernel never launched: {launches}")
    check(all(compress_launches[k] == 1 for k in LANE_KERNELS),
          f"the tiled interp compress did not launch each lane kernel once: {compress_launches}")
    outliers = sum(P._INTERP_LANE_HDR.unpack_from(b, 0)[0] for b in art.tile_blobs)
    tiles = tiled.split_tiles(tiled.pad_to_tiles(x, TILE), TILE)
    xp = P.pad_edge(tiles, P._padded_shape(TILE, art.levels), first_axis=1)
    del tiles
    _, sweeps = interp_sweeps(xp, art.eb_abs, art.levels)
    del xp
    check(sweeps["outliers"] == outliers, "interp_tiled outliers differ between runs")
    emit({"phase": "interp_tiled", "shape": list(SHAPE), "tile": list(TILE),
          "padded_tile": list(P._padded_shape(TILE, art.levels)), "rel_eb": REL_EB,
          "backend": BACKEND, "order": art.order, "levels": art.levels, "eb_abs": art.eb_abs,
          "compress_s": t1 - t0, "decompress_s": t2 - t1, "region_ms": (t3 - t2) * 1e3,
          "roi": [list(r) for r in ROI], "ratio": x_np.nbytes / len(blob),
          "container_bytes": len(blob), "max_abs_err": err, "max_err_over_eb": err / eb32,
          "outliers": outliers, "decode_equals_recon": True, "roi_equals_crop": True,
          "compress_device_peak_bytes": peak,
          "sweeps": sweeps, "compress_launches": compress_launches, "launches": launches})
    return launches, container_id(blob, t1 - t0, peak)


def stream_path(x_np, tmp: Path, eager: dict) -> dict:
    """The out-of-core path: the 512^3 field written to a .npy and streamed
    off its memmap by ``api.compress_stream`` / ``exec.stream_compress``
    under the reference's default 256 MiB budget (``eager``: the main and
    interp_tiled containers, see ``container_id``).  Runs, each fatal:
    (a) Lorenzo, bytes equal to main's; (b) transient device and append
    faults survived with retries == 2, same bytes; (c) a hard fault, then a
    resume, same bytes, open(verify="full"); (d) interp, bytes equal to
    interp_tiled's, error <= float32(eb), ROI == crop; (e) Lorenzo with
    enhancers trained for STREAM_EPOCHS epochs on the reservoir, full decode
    and ROI == crop; (f) every run's tracked peak <= 2 x the budget; (g) the
    three encode kernels launched once per batch, the enhancer's two in (e),
    huffman_decode on the read-backs.  Each run's compress seconds are split
    on the caller's thread by timers wrapped around the executor's rel-eb
    prepass, its batch reads (the memmap copy into the batch included), the
    predictor's encode (synchronized) and lane packing, and the streamed
    training; the rest (uploads, waits on the host stage, reservoir offers,
    finalize) is ``other``.  Returns the phase's launches."""
    import contextlib
    import hashlib

    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core import metrics, trainer
    from repro_torch.core.trainer import GWLZTrainConfig
    from repro_torch.exec import NpyFileSource, executor, journal_path, plan_stream, stream_compress
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault import FailureInjector, RetryPolicy
    from repro_torch.sz import decompress_tiled
    from repro_torch.sz.predictor import get_predictor

    spent = {}  # the current run's seconds by part, and its counts

    @contextlib.contextmanager
    def timed(targets):
        """Wrap each (owner, attribute, key, sync) so a call adds its seconds
        to spent[key] and one to spent[key + "_calls"]; restored on exit."""
        saved = []
        for owner, name, key, sync in targets:
            fn, own = getattr(owner, name), name in vars(owner)

            def wrapped(*a, _fn=fn, _key=key, _sync=sync, **k):
                t = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    if _sync:
                        torch.cuda.synchronize()
                    spent[_key] += time.perf_counter() - t
                    spent[_key + "_calls"] += 1

            saved.append((owner, name, fn, own))
            setattr(owner, name, wrapped)
        try:
            yield
        finally:
            for owner, name, fn, own in reversed(saved):
                if own:
                    setattr(owner, name, fn)
                else:
                    delattr(owner, name)

    parts = ("prepass", "read", "encode", "lane_pack", "train", "train_step")
    targets = [(executor, "_resolve_eb_streaming", "prepass", False),
               (executor, "_read_batch", "read", False),
               (trainer, "train_enhancers_streamed", "train", True),
               (trainer, "train_step", "train_step", False)]
    for pred_name in ("lorenzo", "interp"):
        cls = type(get_predictor(pred_name))
        targets += [(cls, "encode_tiles", "encode", True),
                    (cls, "lane_bytes_batch", "lane_pack", False)]

    src = tmp / "stream_src.npy"
    t0 = time.perf_counter()
    np.save(src, x_np)
    save_s = time.perf_counter() - t0
    kw = dict(rel_eb=REL_EB, tile=TILE, mem_budget=STREAM_BUDGET, backend=BACKEND)
    ops.reset_launches()  # the phase's launches, over every run below
    runs = {}

    def stream(name: str, **extra):
        out = tmp / f"stream_{name}.gwtc"
        before = dict(ops.LAUNCHES)
        spent.update({k: 0.0 for k in parts}, **{k + "_calls": 0 for k in parts})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with timed(targets):
            rep = stream_compress(NpyFileSource(src), str(out), **{**kw, **extra})
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        blob = out.read_bytes()
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        check(rep.peak_tracked_bytes <= 2 * STREAM_BUDGET,
              f"stream {name}: tracked peak {rep.peak_tracked_bytes} past 2 x the budget")
        check(rep.entropy_device and rep.nbytes == len(blob), f"stream {name}: report")
        check(all(launches[k] == rep.n_batches - rep.resumed_batches for k in LANE_KERNELS)
              and launches["lorenzo_quant_tiles"] >= rep.n_batches - rep.resumed_batches,
              f"stream {name}: the encode kernels did not launch once a batch: {launches}")
        split = {k: spent[k] for k in parts[:-1]}
        split["other"] = s - sum(split.values())
        runs[name] = {"compress_s": s, "host_stage_s": rep.host_stage_s,
                      "caller_thread_s": split, "batch_reads": spent["read_calls"],
                      "train_steps": spent["train_step_calls"],
                      "n_batches": rep.n_batches, "batch_tiles": rep.batch_tiles,
                      "peak_tracked_bytes": rep.peak_tracked_bytes,
                      "device_peak_bytes": torch.cuda.max_memory_allocated(),
                      "retries": rep.retries, "failed_batches": list(rep.failed_batches),
                      "resumed_batches": rep.resumed_batches, "container_bytes": len(blob),
                      "sha256": hashlib.sha256(blob).hexdigest(), "launches": launches}
        return rep, out

    dev = torch.device("cuda")
    x = torch.from_numpy(x_np).to(dev)
    roi = roi_key()

    def read_back(name: str, out: Path):
        """Open, full decode and ROI on the card; returns the decode."""
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        with api.open(out) as vol:
            full = torch.from_numpy(np.array(vol)).to(dev)
            check(np.array_equal(vol[roi], full[roi].cpu().numpy()),
                  f"stream {name}: ROI != the full decode's crop")
        runs[name]["decode_s"] = time.perf_counter() - t
        check(ops.LAUNCHES["huffman_decode"] > before["huffman_decode"],
              f"stream {name}: the read-back never launched huffman_decode")
        check(tuple(full.shape) == SHAPE and bool(torch.isfinite(full).all()),
              f"stream {name}: decode shape")
        return full

    lor_plan = plan_stream(SHAPE, TILE, STREAM_BUDGET, device_entropy=True)
    check((lor_plan.batch_tiles, lor_plan.n_batches) == (32, 16), "Lorenzo stream geometry")
    # (a) Lorenzo == the eager main container
    rep, out = stream("lorenzo")
    want = eager["main"]
    check((runs["lorenzo"]["sha256"], rep.nbytes) == (want["sha256"], want["bytes"]),
          "(a) the Lorenzo stream differs from the eager main container")
    full = read_back("lorenzo", out)
    err = float((x.double() - full.double()).abs().max())
    check(err <= rep.eb_abs * (1 + 1e-6), f"(a) error {err} above eb {rep.eb_abs}")
    del full
    # a batch's pageable upload, timed apart on the host clock (the stream
    # makes one a batch; the copy from pageable memory blocks the host)
    batch = np.empty((lor_plan.batch_tiles,) + TILE, np.float32)
    batch[:] = x_np[: TILE[0], : TILE[1], : TILE[2]]
    torch.from_numpy(batch).to(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        torch.from_numpy(batch).to(dev)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t) * 100
    del batch
    # (b) transient faults survived
    rep, out = stream("transient", injector=FailureInjector({1}),
                      write_injector=FailureInjector({5}, exc=OSError),
                      retry=RetryPolicy(max_attempts=3, backoff=0.0))
    check(rep.retries == 2 and runs["transient"]["sha256"] == want["sha256"],
          f"(b) retries {rep.retries} or bytes differ")
    # (c) a hard fault leaves (partial, journal); resume finishes it
    killed = tmp / "stream_resumed.gwtc"
    try:
        stream_compress(NpyFileSource(src), str(killed), **kw,
                        injector=FailureInjector({2}, attempts=9), retry=RetryPolicy(2, 0.0))
        check(False, "(c) the hard fault did not exhaust the retry policy")
    except RuntimeError as e:
        check("injected" in str(e), f"(c) not the injected fault: {e}")
    check(os.path.exists(journal_path(killed)), "(c) no journal after the hard fault")
    rep, out = stream("resumed", resume=True)
    check(rep.resumed_batches == 2 and runs["resumed"]["sha256"] == want["sha256"],
          f"(c) resumed {rep.resumed_batches} batches, or bytes differ")
    check(not os.path.exists(journal_path(killed)), "(c) the journal outlived finalize")
    api.open(killed, verify="full").close()
    # (d) interp == the eager interp_tiled container
    rep, out = stream("interp", predictor="interp")
    want = eager["interp_tiled"]
    check((rep.batch_tiles, rep.n_batches) == (23, 23), "interp stream geometry")
    check((runs["interp"]["sha256"], rep.nbytes) == (want["sha256"], want["bytes"]),
          "(d) the interp stream differs from the eager interp_tiled container")
    full = read_back("interp", out)
    eb32 = float(np.float32(rep.eb_abs))
    err = float((x.double() - full.double()).abs().max())
    check(err <= eb32, f"(d) interp error {err} above eb {eb32}")
    del full
    # (e) enhancers trained on the reservoir sample
    cfg = GWLZTrainConfig(epochs=STREAM_EPOCHS)
    rep, out = stream("enhanced", enhance=cfg)
    check(rep.enhanced and rep.reservoir_tiles == 32, f"(e) reservoir {rep.reservoir_tiles}")
    check(all(runs["enhanced"]["launches"][k] > 0 for k in GWLZ_KERNELS),
          f"(e) an enhancer kernel never launched: {runs['enhanced']['launches']}")
    full = read_back("enhanced", out)
    with api.open(out) as vol:
        sz = decompress_tiled(vol.artifact)  # the container's SZ half, no enhancer
    runs["enhanced"].update(
        psnr_sz=float(metrics.psnr(x, sz)), psnr_enhanced=float(metrics.psnr(x, full)),
        reservoir_tiles=rep.reservoir_tiles, epochs=cfg.epochs)
    check(runs["enhanced"]["train_steps"] > 0, "(e) the streamed training took no step")
    del full, sz, x
    launches = dict(ops.LAUNCHES)
    emit({"phase": "stream", "shape": list(SHAPE), "tile": list(TILE), "rel_eb": REL_EB,
          "backend": BACKEND, "mem_budget": STREAM_BUDGET, "source": "npy memmap",
          "save_npy_s": save_s, "batch_upload_ms": upload_ms,
          "batch_upload_bytes": lor_plan.batch_tiles * int(np.prod(TILE)) * 4,
          "eager": eager, "runs": runs, "launches": launches})
    return launches

def bigstream_path(tmp: Path):
    """One SZJX Lorenzo field whose single Huffman stream is past 2**31 bits:
    integer noise, uniform on [0, 2**16), at 512^3 with abs_eb 0.5 (~17.7
    bits a value), through the façade with the ``huffman`` backend (no host
    zlib), decoded on the card.  Integers keep 2eb q exact in float32, so the
    decode must give x back.  Beside it, [0, 1) noise at 64^3 and rel_eb 1e-5
    (the same bits a value), where the float32 product 2eb q of the Lorenzo
    prequantizer rounds past eb, as the reference's does
    (tests/test_torch_szjx.py, ROADMAP Queue 3): its error is printed, and
    the card's bytes and reconstruction must equal the CPU's."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.sz import SZCompressor, entropy

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 2**16, SHAPE, generator=gen, device="cuda").to(torch.float32)
    path = tmp / "noise.szjx"
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = api.compress(x, abs_eb=BIG_EB, predictor="lorenzo", backend="huffman")
    api.save(path, vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del vol
    with api.open(path) as back:
        full = np.asarray(back)
        t2 = time.perf_counter()
        art = back.artifact
    launches = dict(ops.LAUNCHES)
    codec, n_sym, cs, chunk_bits, _, total = entropy.parse_chunked(art.code_blob)
    check(total >= 2**31, f"the stream has {total} bits, not past 2**31")
    out = torch.from_numpy(full.copy()).cuda()
    err = float((x.double() - out.double()).abs().max())
    check(full.shape == SHAPE and bool(torch.isfinite(out).all()), "bigstream decode shape")
    check(err <= art.eb_abs * (1 + 1e-6), f"bigstream error {err} above eb {art.eb_abs}")
    check(torch.equal(out, x), "bigstream decode is not the integer field")
    check(launches["huffman_decode"] > 0 and launches["huffman_encode"] > 0,
          f"a bigstream kernel never launched: {launches}")
    u = torch.rand((64,) * 3, generator=gen, device="cuda")
    sz = SZCompressor("lorenzo", backend="huffman")
    u_card, u_rec = sz.compress(u, rel_eb=1e-5)
    u_cpu, u_rec_cpu = sz.compress(u.cpu(), rel_eb=1e-5, device="cpu")
    check(u_card.to_bytes() == u_cpu.to_bytes() and torch.equal(u_rec.cpu(), u_rec_cpu),
          "[0, 1) noise: the card's SZJX differs from the CPU's")
    u_err = float((u.double() - u_rec.double()).abs().max())
    emit({"phase": "bigstream", "field": "integers uniform on [0, 2**16), torch seed 0",
          "shape": list(SHAPE), "abs_eb": BIG_EB, "backend": "huffman",
          "eb_abs": art.eb_abs, "stream_bits": int(total),
          "bits_per_value": total / n_sym, "chunks": int(np.asarray(chunk_bits).size),
          "alphabet": int(codec.alphabet.size), "longest_code": int(codec.lengths.max()),
          "compress_s": t1 - t0, "decompress_s": t2 - t1, "max_abs_err": err,
          "container_bytes": path.stat().st_size, "launches": launches,
          "float_noise": {"field": "uniform on [0, 1), 64^3", "rel_eb": 1e-5,
                          "eb_abs": u_card.eb_abs, "max_abs_err": u_err,
                          "err_over_eb": u_err / u_card.eb_abs, "cpu_identical": True}})
    return launches


def gwlz_mono_path(x_np, tmp: Path, phase: str = "gwlz_mono", predictor: str = "lorenzo"):
    """The paper's configuration: monolithic SZ (``predictor``), enhancers
    trained on the full 512x512 slices, through the façade."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GWLZTrainConfig
    from repro_torch.kernels import ops

    cfg = GWLZTrainConfig(epochs=MONO_EPOCHS)
    path = tmp / f"field_{phase}.szjx"
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = api.compress(x_np, eb=REL_EB, predictor=predictor, backend=BACKEND, enhance=cfg)
    api.save(path, vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with api.open(path) as back:
        full = np.asarray(back)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        region = back[roi_key()]
        t3 = time.perf_counter()
        art = back.artifact
    launches = dict(ops.LAUNCHES)

    stats = vol.train_stats
    x = torch.from_numpy(x_np).cuda()
    out = torch.from_numpy(full.copy()).cuda()
    check(full.shape == SHAPE and bool(torch.isfinite(out).all()), f"{phase} decode shape")
    check(art.predictor == predictor, f"{phase}: the container's predictor is {art.predictor}")
    psnr = float(metrics.psnr(x, out))
    check(psnr == stats.psnr_gwlz, f"decode PSNR {psnr} != compress-time {stats.psnr_gwlz}")
    check(np.array_equal(region, full[roi_key()]), "enhanced slice differs from the full crop")
    check(stats.psnr_gwlz >= stats.psnr_sz - 1e-3,
          f"enhancement lost PSNR: {stats.psnr_sz} -> {stats.psnr_gwlz}")
    check(all(launches[k] > 0 for k in GWLZ_KERNELS + SZJX_KERNELS),
          f"a kernel of the path never ran: {launches}")
    from repro_torch.core.pipeline import deserialize_model

    model = deserialize_model(art.extras["gwlz"])
    sec = stats.seconds
    steps = SHAPE[0] // cfg.batch_size * cfg.epochs
    emit({"phase": phase, "predictor": predictor, "field": "temperature",
          "shape": list(SHAPE), "rel_eb": REL_EB, "n_groups": cfg.n_groups,
          "channels": cfg.channels, "batch_size": cfg.batch_size, "epochs": cfg.epochs, "steps": steps,
          "compress_s": t1 - t0, "seconds": sec,
          "train_ms_per_step": 1e3 * sec["train"] / steps, "decompress_s": t2 - t1,
          "region_ms": (t3 - t2) * 1e3, "psnr_sz": stats.psnr_sz,
          "psnr_gwlz": stats.psnr_gwlz, "psnr_gain": stats.psnr_gwlz - stats.psnr_sz,
          "psnr_decode": psnr, "overhead": stats.overhead,
          "ratio_sz": stats.cr_sz, "ratio_gwlz": stats.cr_gwlz,
          "max_err_sz": stats.max_err_sz, "max_err_gwlz": stats.max_err_gwlz,
          "trained_groups": int((np.asarray(stats.loss_history[-1]) > 0).sum()),
          "active_groups": int((model.rscale > 0).sum()),
          "loss_per_epoch": [[round(float(v), 6) for v in row] for row in stats.loss_history],
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches})
    return art, model, launches


def cli_path(tmp: Path) -> None:
    """``python -m repro_torch.cli`` end to end in subprocesses (default
    device: the card), tiled and monolithic."""
    import numpy as np

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    roi = "8:40,0:16,20:52"
    took = {}

    def run(*argv, want=0):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.cli", *argv], env=env,
                           capture_output=True, text=True, timeout=300)
        took.setdefault(argv[0], []).append(time.perf_counter() - t)
        check(r.returncode == want, f"cli {' '.join(argv)} exited {r.returncode}, not "
              f"{want}: {r.stderr[-2000:]}")
        return r.stdout

    sizes = {}
    for mode, flags in (("tiled", ["--tiled", "--tile", "16"]), ("mono", [])):
        f = str(tmp / f"cli_{mode}.gw")
        run("compress", "synthetic:temperature:64", f, "--eb", "1e-3", "--predictor",
            "lorenzo", *flags)
        run("info", f)
        run("region", f, "--roi", roi, "--out", str(tmp / f"roi_{mode}.npy"))
        run("decompress", f, str(tmp / f"full_{mode}.npy"))
        run("verify", f)
        full, part = np.load(tmp / f"full_{mode}.npy"), np.load(tmp / f"roi_{mode}.npy")
        check(np.array_equal(part, full[8:40, 0:16, 20:52]), f"cli {mode}: ROI != full crop")
        sizes[mode] = os.path.getsize(f)
    # the out-of-core path under a 1 MiB budget (8 batches of 8 tiles), then
    # verify: its bytes equal the eager tiled container's; --resume needs --stream
    f = str(tmp / "cli_stream.gw")
    streamed = run("compress", "synthetic:temperature:64", f, "--eb", "1e-3", "--predictor",
                   "lorenzo", "--stream", "--mem-budget", "1M", "--tile", "16").strip()
    run("verify", f)
    check(Path(f).read_bytes() == (tmp / "cli_tiled.gw").read_bytes(),
          f"cli --stream bytes differ from the tiled compress: {streamed}")
    sizes["stream"] = os.path.getsize(f)
    run("compress", "synthetic:temperature:64", str(tmp / "cli_resume.gw"), "--eb", "1e-3",
        "--resume", want=2)
    # the default predictor (interp), monolithic
    f = str(tmp / "cli_interp.gw")
    run("compress", "synthetic:temperature:64", f, "--eb", "1e-3")
    run("decompress", f, str(tmp / "full_interp.npy"))
    run("verify", f)
    check(np.load(tmp / "full_interp.npy").shape == (64, 64, 64), "cli interp: decode shape")
    sizes["interp"] = os.path.getsize(f)
    from repro_torch.sz import TiledCompressed, tiled

    blob = bytearray((tmp / "cli_tiled.gw").read_bytes())
    art = TiledCompressed.from_bytes(bytes(blob))
    blob[tiled.lane_offset(art, 5) + 7] ^= 0x20
    bad = tmp / "cli_bad.gw"
    bad.write_bytes(bytes(blob))
    run("verify", str(bad), want=1)
    # the CI serve smoke: every endpoint over HTTP, a repeated ROI from the cache
    smoke = run("serve", f"nyx={tmp / 'cli_tiled.gw'}", f"dm={tmp / 'cli_stream.gw'}",
                "--port", "0", "--smoke").strip().splitlines()[-1]
    check(smoke.startswith("smoke ok"), f"cli serve --smoke printed {smoke!r}")
    lint = lint_gate(tmp, env)
    emit({"phase": "cli", "input": "synthetic:temperature:64", "roi": roi, "serve_smoke": smoke,
          "container_bytes": sizes, "flipped_lane_verify_exit": 1, "stream_line": streamed,
          "resume_without_stream_exit": 2, "lint": lint,
          "seconds": {k: [round(v, 3) for v in vs] for k, vs in took.items()}})


def lint_gate(tmp: Path, env: dict) -> dict:
    """``python -m repro_torch.cli lint``: the checkout's tree in this
    process (clean, all five rules, timed around ``cli.main``), a copy with
    one seeded RA003 violation in a subprocess (exit 1, that one finding),
    and an unknown rule (exit 2).  Source text only: nothing runs on the
    card."""
    import contextlib
    import io

    from repro_torch import cli

    def in_process(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            try:
                code = cli.main(["lint", *argv])
            except SystemExit as e:
                code = e.code
        return code, out.getvalue()

    port = ROOT / "src" / "repro_torch"
    t = time.perf_counter()
    code, out = in_process("--json")
    lint_s = time.perf_counter() - t
    doc = json.loads(out)
    check(code == 0 and doc["clean"] and Path(doc["root"]) == port
          and doc["rules"] == ["RA001", "RA002", "RA003", "RA004", "RA005"],
          f"lint of the checkout exited {code}: {out[-2000:]}")
    seeded = tmp / "lint_seeded"
    shutil.copytree(port, seeded / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (seeded / "tests").symlink_to(ROOT / "tests")
    shutil.copy(ROOT / "chip_smoke.py", seeded / "chip_smoke.py")
    cu = seeded / "src" / "repro_torch" / "csrc" / "lorenzo_quant.cu"
    cu.write_text(cu.read_text() + '\nextern "C" int lorenzo_unreached(void* stream) '
                                   "{ return 0; }\n")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.cli", "lint", "--json", "--root",
                        str(seeded / "src" / "repro_torch")], env=env, capture_output=True,
                       text=True, timeout=300)
    seeded_s = time.perf_counter() - t
    found = json.loads(r.stdout)["findings"] if r.returncode == 1 else r.stderr[-2000:]
    check(r.returncode == 1 and len(found) == 1 and found[0]["rule"] == "RA003"
          and "lorenzo_unreached" in found[0]["message"],
          f"lint of the seeded copy exited {r.returncode}: {found}")
    unknown, _ = in_process("--rule", "RA999")
    check(unknown == 2, f"lint --rule RA999 exited {unknown}, not 2")
    return {"files": doc["files"], "rules": doc["rules"], "seconds": lint_s,
            "seeded_exit": r.returncode, "seeded_finding": f"{found[0]['path']}:"
            f"{found[0]['line']} {found[0]['rule']}", "seeded_subprocess_s": seeded_s,
            "unknown_rule_exit": unknown}


def gwds_path(x_np, tmp: Path, art, main_id: dict) -> dict:
    """A two-field snapshot of 512^3 fields in one GWDS file: main's tiled
    Lorenzo artifact added whole, and the same field streamed from the
    stream phase's .npy memmap into the envelope's shared sink under the
    256 MiB budget.  Checks: the streamed field's bytes equal main's
    container; api.open (mmap) lists both fields, each decodes bit for bit
    to main's eager decode, the ROI equals the crop; Dataset.build of the
    two artifacts gives the file's bytes; the CLI's info, region --field
    and verify run on the file; a fault injected into the streamed field's
    append fails after one attempt (shared sink: no retry).  Returns the
    phase's launches (the CLI's subprocesses launch in their own
    processes, which this one does not count)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.exec import GWDSWriter, NpyFileSource, stream_compress
    from repro_torch.exec.writer import parse_gwds
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault import FailureInjector, RetryPolicy
    from repro_torch.sz import decompress_tiled

    src = tmp / "stream_src.npy"  # the stream phase's .npy of the same field
    path = tmp / "snapshot.gwds"
    names = ("temperature", "temperature_stream")
    kw = dict(tile=TILE, mem_budget=STREAM_BUDGET, backend=BACKEND)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = GWDSWriter(path)
    w.add_field(names[0], art)
    t1 = time.perf_counter()
    gw = w.stream_field(names[1], shape=SHAPE, tile=TILE, eb_abs=art.eb_abs, backend=BACKEND)
    rep = stream_compress(NpyFileSource(src), gw, rel_eb=REL_EB, **kw)
    total = w.finalize()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    blob = path.read_bytes()
    index = parse_gwds(blob)
    fo, fl = index[names[1]]
    check(total == len(blob) and list(index) == list(names), f"gwds index {index}")
    check(hashlib.sha256(blob[fo:fo + fl]).hexdigest() == main_id["sha256"]
          and fl == main_id["bytes"], "gwds: the streamed field differs from main's container")
    check(api.Dataset.build({names[0]: art, names[1]: art}) == blob,
          "gwds: Dataset.build of the two artifacts differs from the streamed file")
    eager = decompress_tiled(art)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    decode_s = {}
    with api.open(path) as ds:
        t4 = time.perf_counter()
        check(ds.fields == names, f"gwds: api.open lists {ds.fields}")
        for name in names:
            t = time.perf_counter()
            full = torch.from_numpy(np.array(ds[name])).to(eager.device)
            decode_s[name] = time.perf_counter() - t
            check(torch.equal(full, eager), f"gwds: field {name} != main's eager decode")
            del full
        t5 = time.perf_counter()
        region = ds[names[1]][roi_key()]
        t6 = time.perf_counter()
        check(np.array_equal(region, eager[roi_key()].cpu().numpy()), "gwds: ROI != the crop")
        size_report = ds.size_report()
        check(size_report["total"] == len(blob), "gwds: size_report total")
    launches = dict(ops.LAUNCHES)
    del eager
    check(launches["huffman_decode"] > 0 and all(
        launches[k] == rep.n_batches for k in LANE_KERNELS), f"gwds launches {launches}")
    # the CLI on the file, in subprocesses (the card is their default device)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli_s, cli_out = {}, {}
    roi = ",".join(f"{a}:{b}" for a, b in ROI)
    for argv in (["info", str(path)], ["region", str(path), "--roi", roi, "--field", names[0]],
                 ["verify", str(path)]):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.cli", *argv], env=env,
                           capture_output=True, text=True, timeout=300)
        cli_s[argv[0]] = time.perf_counter() - t
        check(r.returncode == 0, f"gwds cli {argv[0]} exited {r.returncode}: {r.stderr[-2000:]}")
        cli_out[argv[0]] = r.stdout.strip().splitlines()
    check(cli_out["info"][0].startswith("GWDS dataset: 2 fields"), f"cli info {cli_out['info']}")
    check(cli_out["verify"] == [f"ok: field {n!r} (512 lanes)" for n in names],
          f"cli verify {cli_out['verify']}")
    # a fault in the streamed field's append: one attempt, no retry
    inj = FailureInjector({5}, exc=OSError)
    try:
        with GWDSWriter(tmp / "fault.gwds") as fw:  # closes the file on the way out
            fgw = fw.stream_field("t", shape=SHAPE, tile=TILE, eb_abs=art.eb_abs,
                                  backend=BACKEND)
            check(not fgw.can_rollback, "gwds: a shared-sink writer claims it can roll back")
            stream_compress(NpyFileSource(src), fgw, abs_eb=art.eb_abs, **kw,
                            write_injector=inj, retry=RetryPolicy(max_attempts=3, backoff=0.0))
        check(False, "gwds: the injected append fault did not fail the stream")
    except OSError as e:
        check("injected" in str(e), f"gwds: not the injected fault: {e}")
    check(inj.failed == {5: 1}, f"gwds: the append was tried {inj.failed} times, not once")
    emit({"phase": "gwds", "shape": list(SHAPE), "tile": list(TILE), "rel_eb": REL_EB,
          "mem_budget": STREAM_BUDGET, "fields": list(names), "envelope_bytes": len(blob),
          "size_report": size_report, "stream_bytes_equal_main": True,
          "n_batches": rep.n_batches, "write_s": t1 - t0, "stream_s": t2 - t1,
          "eager_decode_s": t3 - t2, "open_s": t4 - t3, "decode_s": decode_s,
          "region_ms": (t6 - t5) * 1e3, "cli_s": cli_s, "cli_region": cli_out["region"],
          "fault_attempts": inj.failed[5], "launches": launches})
    return launches


def ckpt_bound(x, eb: float, bf16: bool, enhanced: bool = False):
    """Elementwise bound of a restored compressed leaf: eb (1 + 1e-5) plus one
    float32 ulp of max|x| (the interp coarse grid is Lorenzo-coded and its
    2eb q rounds to float32, in both packages), twice that where the GWLZ
    gate kept a group (``enhanced``: the clamp holds the enhanced value to
    the SZ decode +- eb), plus, for bfloat16, the cast's half ulp (at most
    2^-8 of |x| + eb)."""
    bound = (2 if enhanced else 1) * (eb * (1 + 1e-5) + 2.0**-23 * float(x.abs().max()))
    return bound + 2.0**-8 * (x.abs() + eb) if bf16 else bound


def checkpoint_path(x_np, tmp: Path) -> dict:
    """(a) GWLZ-compressed training state held on the card: a seeded state
    (a 4096 x 4096 projection, float32, through the SZ branch, as every
    2-D leaf; [8, 1024, 2048] experts, float32, through the GWLZ branch; a
    bfloat16 [32000, 128]
    embedding through the SZ branch; a norm vector and an int64 step,
    exact) saved by an async CheckpointManager(gwlz_rel_eb=1e-4), waited
    for and restored into like-shaped tensors on the card.  (b) A
    ResilientLoop over the port's enhancer training step (G = 20, C = 9,
    batch 10 of the szjx decode's 512 x 512 planes and their residuals), 40
    steps with a checkpoint every 10: once clean, once with failures
    injected at steps 17 and 31, each under a HeartbeatMonitor; cuDNN is
    deterministic for the phase, so the two must end bit for bit equal.
    Returns the phase's launches."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import grouping
    from repro_torch.core.enhancer import GroupEnhancers
    from repro_torch.core.pipeline import deserialize_model
    from repro_torch.core.trainer import GWLZTrainConfig, _per_group_scale, train_step
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import step_decay
    from repro_torch.runtime import FailureInjector, HeartbeatMonitor, ResilientLoop
    from repro_torch.sz.szjax import SZCompressed

    dev = torch.device("cuda")
    ops.reset_launches()
    # (a) the state
    g = torch.Generator(device=dev).manual_seed(0)
    state = {"proj": torch.randn(4096, 4096, generator=g, device=dev) * 0.02,
             "experts": torch.randn(8, 1024, 2048, generator=g, device=dev) * 0.02,
             "emb": torch.randn(32000, 128, generator=g, device=dev).to(torch.bfloat16),
             "norm": 1 + 0.1 * torch.randn(4096, generator=g, device=dev),
             "step": torch.tensor(123456789, dtype=torch.int64, device=dev)}
    ckdir = tmp / "ckpt"
    m = CheckpointManager(ckdir, gwlz_rel_eb=CKPT_REL_EB, async_save=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.save(1, state)
    t1 = time.perf_counter()
    m.wait()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    save_peak = torch.cuda.max_memory_allocated()
    target = {k: torch.zeros_like(v) for k, v in state.items()}
    out = m.restore(target)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    step_dir = ckdir / "step_00000001"
    with open(step_dir / "manifest.json") as f:
        manifest = json.load(f)
    check(manifest["gwlz"] == {"emb": True, "experts": True, "proj": True},
          f"checkpoint: compressed leaves {manifest['gwlz']}")
    leaves = {}
    for k, v in state.items():
        r = out[k]
        check(r.dtype == v.dtype and r.device == v.device and r.shape == v.shape,
              f"checkpoint: leaf {k} restored as {r.dtype} on {r.device}")
        row = {"dtype": str(v.dtype).removeprefix("torch."), "shape": list(v.shape),
               "raw_bytes": v.numel() * v.element_size()}
        if k in manifest["gwlz"]:
            xf = v.float()
            eb = CKPT_REL_EB * float(xf.max() - xf.min())
            err = (r.float() - xf).abs()
            blob = (step_dir / f"{k}.gwlz").read_bytes()
            art = SZCompressed.from_bytes(blob[6 + len(row["dtype"]) + 8 * v.ndim:])
            row.update(disk_bytes=len(blob), eb=eb, max_abs_err=float(err.max()),
                       err_over_eb=float(err.max()) / eb, sz_shape=list(art.shape),
                       branch="gwlz" if "gwlz" in art.extras else "sz")
            if "gwlz" in art.extras:  # the groups the gate kept (0: the SZ decode as is)
                model = deserialize_model(art.extras["gwlz"], device=dev)
                row["groups_kept"] = int((model.rscale > 0).sum())
            enhanced = row.get("groups_kept", 0) > 0
            check(bool((err <= ckpt_bound(xf, eb, v.dtype == torch.bfloat16, enhanced)).all()),
                  f"checkpoint: leaf {k} past its bound (max err {float(err.max())}, eb {eb}, "
                  f"groups kept {row.get('groups_kept', 0)})")
        else:
            check(torch.equal(r, v), f"checkpoint: exact leaf {k} differs")
            row["branch"] = "exact"
        leaves[k] = row
    save_launches = dict(ops.LAUNCHES)
    check(leaves["proj"]["branch"] == "sz" and leaves["experts"]["branch"] == "gwlz",
          f"checkpoint: proj went down the {leaves['proj']['branch']} branch, experts the "
          f"{leaves['experts']['branch']} one (a 2-D leaf takes the SZ branch)")
    for row in leaves.values():
        if "disk_bytes" in row:
            row["of_raw"] = row["disk_bytes"] / row["raw_bytes"]
    del state, target, out
    # (b) the restart loop over the enhancer's training step
    with api.open(tmp / "field.szjx") as vol:
        recon = torch.from_numpy(np.array(vol)).to(dev)
    xs, rs = recon, torch.from_numpy(x_np).to(dev) - recon
    del recon
    cfg = GWLZTrainConfig()
    G, bs, n_steps = cfg.n_groups, cfg.batch_size, LOOP_STEPS
    edges = grouping.compute_edges(xs, G, cfg.strategy)
    ids, counts = ops.group_hist_op(xs, edges)
    rscale = torch.where(counts >= cfg.min_group_pixels, _per_group_scale(rs, ids, G), 0.0)
    steps_per_epoch = xs.shape[0] // bs
    sched = step_decay(cfg.lr, cfg.lr_decay_factor, cfg.lr_decay_every_epochs * steps_per_epoch)
    order = torch.from_numpy(np.random.default_rng(cfg.seed).permutation(xs.shape[0])).to(dev)
    enh = GroupEnhancers(G, cfg.channels, device=dev,
                         generator=torch.Generator().manual_seed(cfg.seed))

    def initial():
        opt = adamw.init(enh.params())
        return {"params": {k: p.detach().clone() for k, p in enh.params().items()},
                "bn": {k: v.clone() for k, v in enh.state().items()},
                "m": opt["m"], "v": opt["v"],
                "adam_step": torch.tensor(0, dtype=torch.int64, device=dev)}

    init = initial()

    def batch_fn(step):
        pos = step % steps_per_epoch
        return order[pos * bs:(pos + 1) * bs], sched(step)

    def step_fn(s, batch):
        idx, lr = batch
        enh.load(s["params"], s["bn"])
        opt = {"step": int(s["adam_step"]), "m": s["m"], "v": s["v"]}
        losses = train_step(enh, opt, xs[idx], rs[idx], ids[idx], edges, rscale, lr,
                            n_groups=G, residual_learning=cfg.residual_learning)
        return ({"params": {k: p.detach().clone() for k, p in enh.params().items()},
                 "bn": {k: v.clone() for k, v in enh.state().items()},
                 "m": opt["m"], "v": opt["v"],
                 "adam_step": torch.tensor(opt["step"], dtype=torch.int64, device=dev)},
                {"loss": losses})

    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    runs = {}
    try:
        for name, fail_at in (("clean", set()), ("failed", set(LOOP_FAILS))):
            mgr = CheckpointManager(tmp / f"loop_{name}", async_save=True, keep=5)
            restores = []
            real_restore = mgr.restore

            def timed_restore(*a, _real=real_restore, _log=restores, **k):
                t = time.perf_counter()
                r = _real(*a, **k)
                torch.cuda.synchronize()
                _log.append(time.perf_counter() - t)
                return r

            mgr.restore = timed_restore
            loop = ResilientLoop(step_fn, batch_fn, mgr, ckpt_every=LOOP_EVERY)
            start = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                         else v.clone()) for k, v in init.items()}
            monitor = HeartbeatMonitor(n_workers=1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            final, log, restarts = loop.run(start, n_steps, injector=FailureInjector(fail_at),
                                            monitor=monitor)
            torch.cuda.synchronize()
            beats = monitor._times.get(0, [])
            check(len(beats) == min(len(log), monitor.window),
                  f"checkpoint loop: {len(beats)} heartbeats for {len(log)} steps")
            runs[name] = {"seconds": time.perf_counter() - t, "restarts": restarts,
                          "steps_run": len(log), "restore_s": restores,
                          "checkpoints": mgr.all_steps(), "final": final,
                          "heartbeat_median_s": float(np.median(beats)),
                          "stragglers": monitor.stragglers()}
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    clean, failed = runs["clean"], runs["failed"]
    check(clean["restarts"] == 0 and failed["restarts"] == 2,
          f"checkpoint loop restarts {clean['restarts']}, {failed['restarts']}")
    a, b = clean.pop("final"), failed.pop("final")
    diffs = {}
    for group in ("params", "bn", "m", "v"):
        for k in a[group]:
            diffs[f"{group}/{k}"] = float((a[group][k] - b[group][k]).abs().max())
    check(int(a["adam_step"]) == int(b["adam_step"]) == n_steps, "checkpoint loop: adam step")
    check(all(d == 0.0 for d in diffs.values()),
          f"checkpoint loop: the restarted run differs from the clean one: {diffs}")
    replayed = failed["steps_run"] - n_steps
    ms_step = clean["seconds"] / n_steps * 1e3
    launches = dict(ops.LAUNCHES)
    emit({"phase": "checkpoint", "rel_eb": CKPT_REL_EB, "save_s": t1 - t0, "wait_s": t2 - t1,
          "restore_s": t3 - t2, "save_device_peak_bytes": save_peak, "leaves": leaves,
          "save_restore_launches": save_launches,
          "loop": {"G": G, "C": cfg.channels, "batch": bs, "plane": list(SHAPE[1:]),
                   "steps": n_steps, "ckpt_every": LOOP_EVERY, "fail_at": list(LOOP_FAILS),
                   "runs": runs, "replayed_steps": replayed, "ms_per_step": ms_step,
                   "restart_s": (failed["seconds"] - clean["seconds"]) / failed["restarts"],
                   "restart_s_minus_replay": (failed["seconds"] - clean["seconds"]
                                              - replayed * ms_step / 1e3) / failed["restarts"],
                   "bit_equal": True, "cudnn_deterministic": True},
          "launches": launches})
    return launches


def gwlz_dist_path(x_np, tmp: Path) -> dict:
    """The distributed GWLZ step (``launch/gwlz_dist.py``) at the gwlz-nyx
    widths (G = 32, C = 9, 512 x 512 slices), a batch of DIST_BATCH slices
    (gwlz_nyx's global batch is 512) of the szjx phase's Lorenzo decode,
    residuals against the field, edges from ``compute_edges`` of the whole
    decode, rscale its per-group max |r|: DIST_STEPS steps with gradient
    compression off, then as many with it on, each run from the same seeded
    init on consecutive slices.  Checks: finite losses, one group_hist
    launch a step, and ``grad_compress.apply`` through a one-rank NCCL
    group equal bit for bit to the single-shard ``apply``.  Returns the
    launches of the two runs."""
    import dataclasses
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.core import grouping
    from repro_torch.core.trainer import _per_group_scale
    from repro_torch.kernels import ops
    from repro_torch.launch.gwlz_dist import DistGWLZConfig, build_state, make_dist_train_step
    from repro_torch.optim import grad_compress

    dev = torch.device("cuda")
    with api.open(tmp / "field.szjx") as vol:
        xs = torch.from_numpy(np.array(vol)).to(dev)
    rs = torch.from_numpy(x_np).to(dev) - xs
    base = dataclasses.replace(DistGWLZConfig(), batch_slices=DIST_BATCH)
    G, B = base.n_groups, base.batch_slices
    edges = grouping.compute_edges(xs, G)
    ids, _ = ops.group_hist_op(xs, edges)
    rscale = _per_group_scale(rs, ids, G)
    del ids
    runs, launches = {}, {k: 0 for k in ops.LAUNCHES}
    for on in (False, True):
        cfg = dataclasses.replace(base, grad_compress=on)
        state = build_state(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        step = make_dist_train_step(cfg, device=dev)
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(DIST_STEPS):
            batch = {"x": xs[i * B:(i + 1) * B], "r": rs[i * B:(i + 1) * B], "edges": edges,
                     "rscale": rscale}
            t = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss.sum()))
        check(all(np.isfinite(losses)), f"gwlz_dist (compress {on}): losses {losses}")
        check(ops.LAUNCHES["group_hist"] == DIST_STEPS,
              f"gwlz_dist: group_hist launched {ops.LAUNCHES['group_hist']} times in "
              f"{DIST_STEPS} steps")
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        runs["compressed" if on else "plain"] = {
            "ms_per_step": float(np.median(times[1:])) * 1e3, "first_step_ms": times[0] * 1e3,
            "loss_sums": losses, "device_peak_bytes": torch.cuda.max_memory_allocated()}
        params = state["params"]
        del state
    numel = sum(p.numel() for p in params.values())
    # grad_compress.apply through a one-rank NCCL group == the single-shard apply
    g = torch.Generator(device=dev).manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=g, device=dev) for k, p in params.items()}
    ef = {k: 0.01 * torch.randn(p.shape, generator=g, device=dev) for k, p in params.items()}
    gc_cfg = grad_compress.GradCompressConfig(rel_eb=base.gc_rel_eb)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        single = grad_compress.apply(grads, ef, gc_cfg)
        reduced = grad_compress.apply(grads, ef, gc_cfg, group=dist.group.WORLD)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for side in (0, 1):
        for k in grads:
            check(torch.equal(single[side][k], reduced[side][k]),
                  f"gwlz_dist: apply through a 1-rank NCCL group differs at {k}")
    emit({"phase": "gwlz_dist", "G": G, "C": base.channels, "batch_slices": B,
          "slice": list(SHAPE[1:]), "steps": DIST_STEPS, "gc_rel_eb": base.gc_rel_eb,
          "runs": runs, "params": numel,
          "grad_code_bytes": numel + 4 * len(params), "grad_fp32_bytes": 4 * numel,
          "nccl_one_rank_equal": True, "launches": launches})
    return launches


def lm_train_path(tmp: Path) -> dict:
    """The dense-decoder LM's training on the card: granite-3-8b at full
    width (d 4096, 32 heads, kv 8, head_dim 128, ff 12800, vocab 49155),
    LM_LAYERS of its 40 layers, batch LM_BATCH x seq LM_SEQ of the token
    pipeline, under deterministic algorithms.  (b), run first: LM_TIMED
    steps each with bf16 and int8 moments, every step synchronized and
    timed.  (a) ResilientLoop over ``launch/steps.py``'s step with
    LM_MOMENTS moments, LM_STEPS steps, a plain checkpoint every LM_EVERY:
    once clean, once with a failure injected at step LM_FAIL; checks the
    loss falls and the restarted run ends bit-equal to the clean one.  The
    three runs start from one seeded init, so their first losses are
    equal.  (c) The trained
    embedding [49155, 4096] alone through ``compress_tensor`` at rel_eb
    1e-4 (the SZ branch, as every 2-D leaf), within its bound.  (d) The
    reference test's command through ``python -m repro_torch.launch.train``
    on the card (reduced), which must exit 0 after its restart.  Returns
    the phase's launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager, compress_tensor, decompress_tensor
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import TrainOptions, make_train_step
    from repro_torch.launch.train import deterministic, make_loop_step, prng_key
    from repro_torch.models.decoder import DecoderLM, default_pattern
    from repro_torch.optim import adamw
    from repro_torch.runtime import FailureInjector, HeartbeatMonitor, ResilientLoop
    from repro_torch.sz.szjax import SZCompressed

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS,
                              pattern=default_pattern(LM_LAYERS, rope_theta=1e4))
    model = DecoderLM(cfg, device=dev)
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, LM_BATCH, LM_SEQ, seed=0))
    tokens = LM_BATCH * LM_SEQ

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}

    def fresh(moments: str):
        """The seeded initial state and the loop's step, the same every run."""
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        step_fn, adam_cfg = make_train_step(model, cfg, TrainOptions(
            lr=LM_LR, warmup=max(LM_STEPS // 10, 1), total_steps=LM_STEPS,
            moment_dtype=moments))
        return make_loop_step(step_fn), (params, adamw.init(params, adam_cfg), prng_key(1))

    def timed(mgr, name: str, log: dict):
        real = getattr(mgr, name)

        def call(*a, **k):
            t = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            log.setdefault(name, []).append(time.perf_counter() - t)
            return out

        setattr(mgr, name, call)

    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, finals = {}, {}
    with deterministic(dev):
        # (b) steps timed one by one (first: they also warm the card up)
        step_ms, step_losses = {}, {}
        for moments in ("bf16", "int8"):
            loop_step, state = fresh(moments)
            n_params = sum(p.numel() for _, p in tree.leaves(state[0]))
            times, ls = [], []
            for i in range(LM_TIMED):
                batch = batch_fn(i)
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = loop_step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                ls.append(float(m["loss"]))
            step_ms[moments] = float(np.median(times[1:])) * 1e3
            step_losses[moments] = ls
            del state, loop_step
        for name, fail_at in (("clean", set()), ("failed", {LM_FAIL})):
            loop_step, state = fresh(LM_MOMENTS)
            mgr = CheckpointManager(tmp / f"lm_{name}", keep=1)
            io = {}
            for method in ("save", "wait", "restore"):
                timed(mgr, method, io)
            monitor = HeartbeatMonitor(n_workers=1)
            loop = ResilientLoop(loop_step, batch_fn, mgr, ckpt_every=LM_EVERY)
            torch.cuda.synchronize()
            t = time.perf_counter()
            final, log, restarts = loop.run(state, LM_STEPS, injector=FailureInjector(fail_at),
                                            monitor=monitor)
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t, "restarts": restarts,
                          "steps_run": len(log), "losses": [float(m["loss"]) for m in log],
                          "save_s": io.get("save", []), "wait_s": io.get("wait", []),
                          "restore_s": io.get("restore", []),
                          "heartbeat_median_s": float(np.median(monitor._times.get(0, [0])))}
            finals[name] = final
            del state, final, loop, loop_step
            shutil.rmtree(tmp / f"lm_{name}")
        clean, failed = runs["clean"], runs["failed"]
        check(clean["restarts"] == 0 and failed["restarts"] == 1,
              f"lm_train restarts {clean['restarts']}, {failed['restarts']}")
        losses = clean["losses"]
        check(all(np.isfinite(losses)) and min(losses[-5:]) < losses[0],
              f"lm_train: the loss did not fall: {losses}")
        differ = [path for (path, a), (_, b) in zip(tree.leaves(finals["clean"]),
                                                    tree.leaves(finals["failed"]))
                  if not torch.equal(torch.as_tensor(a), torch.as_tensor(b))]
        check(not differ, f"lm_train: the restarted run differs from the clean one at {differ}")
        emb = finals["clean"][0]["embed"].detach()
        del finals
        check(step_losses["bf16"][0] == step_losses["int8"][0] == losses[0],
              "lm_train: the first loss differs between runs from the same init")
    peak = torch.cuda.max_memory_allocated()
    train_launches = dict(ops.LAUNCHES)
    # (c) the trained embedding through compress_tensor (the SZ branch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    blob = compress_tensor(emb, rel_eb=CKPT_REL_EB)
    torch.cuda.synchronize()
    emb_s = time.perf_counter() - t
    art = SZCompressed.from_bytes(blob[6 + len("bfloat16") + 16:])
    back = decompress_tensor(blob)
    xf = emb.float()
    eb = CKPT_REL_EB * float(xf.max() - xf.min())
    err = (back.float() - xf).abs()
    check("gwlz" not in art.extras and back.dtype == torch.bfloat16,
          "lm_train: the embedding did not take the SZ branch")
    check(bool((err <= ckpt_bound(xf, eb, True)).all()),
          f"lm_train: the embedding past its bound ({float(err.max())}, eb {eb})")
    embedding = {"shape": list(emb.shape), "dtype": "bfloat16", "seconds": emb_s,
                 "disk_bytes": len(blob), "of_raw_bf16": len(blob) / (2 * emb.numel()),
                 "of_fp32": len(blob) / (4 * emb.numel()), "eb": eb,
                 "err_over_eb": float(err.max()) / eb, "branch": "sz"}
    del emb, back, xf, err
    launches = dict(ops.LAUNCHES)
    # (d) the reference test's command through the CLI on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                        "--reduced", "--steps", "40", "--batch", "4", "--seq", "16",
                        "--lr", "3e-3", "--ckpt-every", "8", "--ckpt-dir", str(tmp / "lm_cli"),
                        "--inject-failure-at", "12", "--gwlz-ckpt-eb", "1e-4"],
                       env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t
    check(r.returncode == 0 and "restarts=1" in r.stdout,
          f"lm_train: the driver exited {r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
    ms = clean["seconds"] / LM_STEPS * 1e3
    emit({"phase": "lm_train", "arch": LM_ARCH, "layers": f"{LM_LAYERS} of 40",
          "d_model": cfg.d_model, "heads": cfg.attn.n_heads, "kv_heads": cfg.attn.n_kv_heads,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": n_params, "batch": LM_BATCH,
          "seq": LM_SEQ, "moments": LM_MOMENTS, "steps": LM_STEPS, "ckpt_every": LM_EVERY,
          "fail_at": LM_FAIL, "runs": runs, "bit_equal": True,
          "loop_ms_per_step": ms,
          "restart_s": (failed["seconds"] - clean["seconds"]) / failed["restarts"],
          "timed_ms_per_step": step_ms, "timed_losses": step_losses,
          "tokens_per_s": tokens / step_ms[LM_MOMENTS] * 1e3,
          "bf16_dense_peak_share": 6 * n_params * tokens / (step_ms[LM_MOMENTS] / 1e3)
          / BF16_OPS_PER_S,
          "device_peak_bytes": peak, "train_launches": train_launches,
          "embedding": embedding, "cli": {"seconds": cli_s, "stdout": r.stdout.strip()[-300:]},
          "launches": launches})
    return launches


def tree_bytes(t) -> int:
    from repro_torch import tree

    return sum(x.numel() * x.element_size() for _, x in tree.leaves(t))


def decode_read_bytes(model, params, cache_bytes: int, enc_out_bytes: int = 0) -> int:
    """The bytes one decode step reads at least: every weight once (the
    shared block once an invocation; rwkv6's ``ffn``, which no forward
    reads, left out), every cache and state whole, and an
    encoder-decoder's encoder output twice a decoder layer (cross-attention
    recomputes its keys and values from it every step)."""
    from repro_torch.models.encdec import EncDecLM

    if isinstance(model, EncDecLM):
        return tree_bytes(params) + cache_bytes + 2 * model.cfg.n_layers * enc_out_bytes
    total = cache_bytes
    for key, sub in params.items():
        if not key.startswith("stage"):
            total += 0 if key == "shared" else tree_bytes(sub)
            continue
        stage = model.stages[int(key[len("stage"):])]
        for spec, slot in zip(stage.specs, sub):
            if slot is None:
                total += stage.count * tree_bytes(params["shared"])
            else:
                total += tree_bytes({k: v for k, v in slot.items()
                                     if not (spec.kind == "rwkv6" and k == "ffn")})
    return total


def serve_driver(arch: str, batch: int, ctx: int, prompt: int, gen: int, params):
    """``launch.serve.main`` at full size with ``params`` (the driver's own
    seeded init, made by the caller so that it can count them) -> (the
    generated tokens, the driver's ``key=value`` pairs, its wall seconds,
    its stdout)."""
    import contextlib
    import io

    from repro_torch.launch import serve

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        tokens = serve.main(["--arch", arch, "--batch", str(batch), "--ctx", str(ctx),
                             "--prompt-len", str(prompt), "--gen-len", str(gen)], params=params)
    wall = time.perf_counter() - t
    said = dict(kv.split("=", 1) for kv in out.getvalue().split() if "=" in kv)
    return tokens, said, wall, out.getvalue().strip()


def fresh_peak() -> int:
    """Resets the card's peak; returns the bytes still allocated (the base
    of the next check's peak)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def profile_decode(step, params, cache, batch: int, extra=None) -> tuple[float, dict]:
    """A steady decode step: its ms over 32 steps after 16 warm-up steps,
    then PROFILED steps under torch.profiler after a dropped warm-up step:
    (steady ms, {"steps", "ms", "device_ops", "device_busy_ms",
    "device_busy_share", "top_device_ms"}), a step each.  ``cache`` is
    written (positions 0-52); ``extra`` joins every step's batch."""
    import torch

    dev = torch.device("cuda")
    extra = extra or {}
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    positions = torch.arange(64, dtype=torch.int32, device=dev)
    run = lambda p: step(params, cache, {"token": tok, "pos": positions[p], **extra})
    with torch.no_grad():
        for p in range(16):  # warm-up
            run(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(16, 48):
            run(p)
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) / 32 * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        warm_then_trace = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=warm_then_trace) as prof:
            run(48)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for p in range(49, 49 + PROFILED):
                run(p)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
            prof.step()
    # device-side events only (kernels, memcpy, memset), not the step's own span
    on_dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 / PROFILED
    top = sorted(((e.key, e.self_device_time_total / 1e3 / PROFILED) for e in on_dev),
                 key=lambda kv: -kv[1])[:8]
    return steady_ms, {"steps": PROFILED, "ms": prof_ms,
                       "device_ops": sum(e.count for e in on_dev) / PROFILED,
                       "device_busy_ms": busy_ms, "device_busy_share": busy_ms / prof_ms,
                       "top_device_ms": dict(top)}


def lm_serve_path() -> None:
    """LM serving on the card (module docstring, phase 12g): five checks,
    each emitting its JSON line.  Checks that no kernel of ``csrc/`` is
    launched (the path has none)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.attention import MASK_SLIDING
    from repro_torch.models.decoder import DecoderLM

    dev = torch.device("cuda")
    ops.reset_launches()

    # (a) gemma3-1b at full depth through the driver, then one profiled step
    cfg = get_config(SERVE_ARCH)
    model = DecoderLM(cfg, device=dev)
    resident = fresh_peak()
    params = model.init(torch.Generator(device=dev).manual_seed(0))  # the driver's own init
    gen, said, wall, stdout = serve_driver(SERVE_ARCH, SERVE_BATCH, SERVE_CTX, SERVE_PROMPT,
                                           SERVE_GEN, params)
    peak = torch.cuda.max_memory_allocated()
    ms, tok_s = float(said["ms/step"]), float(said["tokens/s"].replace(",", ""))
    check(gen.shape == (SERVE_BATCH, SERVE_GEN) and gen.min() >= 0 and gen.max() < cfg.vocab,
          f"lm_serve (a): generated {gen.shape}, range [{gen.min()}, {gen.max()}]")
    cache = model.init_cache(SERVE_BATCH, SERVE_CTX, dtype=cfg.compute_dtype)
    steady_ms, prof = profile_decode(make_decode_step(model), params, cache, SERVE_BATCH)
    check(prof["device_ops"] > 0, "lm_serve (a): the profiler saw no device operation")
    w_bytes, kv_bytes = tree_bytes(params), tree_bytes(cache)
    n_params = sum(x.numel() for _, x in tree.leaves(params))
    emit({"phase": "lm_serve", "check": "a", "arch": SERVE_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.attn.n_heads, "kv_heads": cfg.attn.n_kv_heads,
          "head_dim": cfg.attn.head_dim, "vocab": cfg.vocab, "params": n_params, "dtype": "bf16",
          "batch": SERVE_BATCH, "ctx": SERVE_CTX, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
          "steps": SERVE_PROMPT + SERVE_GEN - 1, "driver_s": wall,
          "ms_per_step": ms, "tokens_per_s": tok_s, "steady_ms_per_step": steady_ms,
          "weight_bytes": w_bytes, "kv_cache_bytes": kv_bytes,
          "hbm_share": (w_bytes + kv_bytes) / (ms / 1e3) / HBM_BYTES_PER_S,
          "steady_hbm_share": (w_bytes + kv_bytes) / (steady_ms / 1e3) / HBM_BYTES_PER_S,
          "profiled_step": {**prof,
                            "busy_share_of_steady_step": prof["device_busy_ms"] / steady_ms},
          "device_peak_bytes": peak, "resident_before_bytes": resident,
          "driver_stdout": stdout[-300:]})
    del params, cache, model

    # (b) decode == prefill at full width, float32, past the window
    full_cfg = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full_cfg, dtype="fp32", remat=False, n_layers=SERVE_PREFILL_LAYERS,
                              pattern=full_cfg.pattern[:SERVE_PREFILL_LAYERS])
    model = DecoderLM(cfg, device=dev)
    resident = fresh_peak()
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, SERVE_PREFILL)).astype(np.int32)).to(dev)
    positions = torch.arange(SERVE_PREFILL, dtype=torch.int32, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _, _ = model.apply(params, toks, positions)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = model.init_cache(2, SERVE_PREFILL, dtype=torch.float32)
        dec = torch.empty_like(full)
        t0 = time.perf_counter()
        for p in range(SERVE_PREFILL):
            dec[:, p], cache = model.decode_step(params, cache, toks[:, p:p + 1], positions[p])
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        rel = float((full - dec).abs().max()) / float(full.abs().max())
    check(bool(torch.isfinite(full).all()) and rel < 2e-3,
          f"lm_serve (b): decode != prefill, max relative error {rel}")
    emit({"phase": "lm_serve", "check": "b", "arch": SERVE_ARCH, "dtype": "fp32", "batch": 2,
          "layers": f"{SERVE_PREFILL_LAYERS} of {full_cfg.n_layers}",
          "reduced": [f"depth {full_cfg.n_layers} -> {SERVE_PREFILL_LAYERS} layers (one 5:1 "
                      "period)"],
          "positions": SERVE_PREFILL, "window": max(sp.window for sp in cfg.pattern),
          "banded_layers": sum(sp.mask_mode == MASK_SLIDING for sp in cfg.pattern),
          "max_rel_err": rel, "bound": 2e-3, "prefill_s": prefill_s,
          "ms_per_step": dec_s / SERVE_PREFILL * 1e3,
          "tokens_per_s": 2 * SERVE_PREFILL / dec_s, "kv_cache_bytes": tree_bytes(cache),
          "device_peak_bytes": torch.cuda.max_memory_allocated(),
              "resident_before_bytes": resident})
    del params, cache, full, dec, model

    # (c) llama4-scout and deepseek-v3 at full width, reduced depth
    for arch, layers in SERVE_MOE:
        full_cfg = get_config(arch)
        cfg = dataclasses.replace(full_cfg, n_layers=layers, pattern=full_cfg.pattern[:layers])
        model = DecoderLM(cfg, device=dev)
        resident = fresh_peak()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cache = model.init_cache(SERVE_MOE_BATCH, SERVE_MOE_CTX, dtype=cfg.compute_dtype)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_MOE_BATCH, SERVE_MOE_PROMPT)).astype(np.int32)).to(dev)
        n_steps = SERVE_MOE_PROMPT + SERVE_MOE_GEN - 1
        with torch.no_grad():
            serve.generate(make_decode_step(model), params, cache, prompt[:, :2], 1)  # warm-up
            cache = model.init_cache(SERVE_MOE_BATCH, SERVE_MOE_CTX, dtype=cfg.compute_dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen, logits = serve.generate(make_decode_step(model), params, cache, prompt,
                                         SERVE_MOE_GEN)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()) and tuple(gen.shape) == (SERVE_MOE_BATCH,
                                                                         SERVE_MOE_GEN),
              f"lm_serve (c) {arch}: non-finite logits or generated {tuple(gen.shape)}")
        shapes = {"/".join(path): list(x.shape) for path, x in tree.leaves(cache)
                  if path[-1] != "pos"}
        if cfg.attn.mla is not None:
            m = cfg.attn.mla
            check(all(sh[1:] == [SERVE_MOE_BATCH, SERVE_MOE_CTX,
                                 m.kv_lora if p.endswith("c_kv") else m.rope_dim]
                      for p, sh in shapes.items()),
                  f"lm_serve (c) {arch}: the MLA cache is not latent-sized: {shapes}")
        w_bytes, kv_bytes = tree_bytes(params), tree_bytes(cache)
        ms = dt / n_steps * 1e3
        emit({"phase": "lm_serve", "check": "c", "arch": arch, "dtype": "bf16",
              "layers": f"{layers} of {full_cfg.n_layers}",
              "reduced": [f"depth {full_cfg.n_layers} -> {layers} layers"],
              "params": sum(x.numel() for _, x in tree.leaves(params)), "init_s": init_s,
              "batch": SERVE_MOE_BATCH, "ctx": SERVE_MOE_CTX, "steps": n_steps,
              "ms_per_step": ms, "tokens_per_s": SERVE_MOE_BATCH * n_steps / dt,
              "weight_bytes": w_bytes, "kv_cache_bytes": kv_bytes, "cache_shapes": shapes,
              "hbm_share": (w_bytes + kv_bytes) / (ms / 1e3) / HBM_BYTES_PER_S,
              "device_peak_bytes": torch.cuda.max_memory_allocated(),
              "resident_before_bytes": resident})
        del params, cache, model, gen, logits

    # (d) the card against the CPU on the three reduced configs, float32
    worst = {}
    resident = fresh_peak()
    for arch in ("gemma3-1b", "llama4-scout-17b-a16e", "deepseek-v3-671b"):
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="fp32")
        cpu_m, card_m = DecoderLM(cfg, device="cpu"), DecoderLM(cfg, device=dev)
        cpu_p = cpu_m.init(torch.Generator().manual_seed(0))
        card_p = tree.rebuild(cpu_p, lambda _, x: x.to(dev))
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (2, SERVE_CPU_STEPS)).astype(np.int32))
        caches = (cpu_m.init_cache(2, 16, dtype=torch.float32),
                  card_m.init_cache(2, 16, dtype=torch.float32))
        errs = []
        with torch.no_grad():
            for p in range(SERVE_CPU_STEPS):
                a, ca = cpu_m.decode_step(cpu_p, caches[0], toks[:, p:p + 1], p)
                b, cb = card_m.decode_step(card_p, caches[1], toks[:, p:p + 1].to(dev), p)
                caches = (ca, cb)
                errs.append(float((b.cpu() - a).abs().max()) / float(a.abs().max()))
        worst[arch] = max(errs)
        check(worst[arch] <= 1e-4, f"lm_serve (d) {arch}: card != CPU, {worst[arch]} max|logits|")
    emit({"phase": "lm_serve", "check": "d", "dtype": "fp32", "steps": SERVE_CPU_STEPS,
          "max_abs_err_over_max_logits": worst, "bound": 1e-4,
          "device_peak_bytes": torch.cuda.max_memory_allocated(),
              "resident_before_bytes": resident})

    # (e) the driver on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma3-1b",
                        "--reduced"], env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t
    check(r.returncode == 0 and "tokens/s=" in r.stdout,
          f"lm_serve (e): the driver exited {r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
    said = dict(kv.split("=", 1) for kv in r.stdout.split() if "=" in kv)
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()), f"lm_serve: a codec kernel was launched: {launches}")
    emit({"phase": "lm_serve", "check": "e", "seconds": cli_s,
          "ms_per_step": float(said["ms/step"]),
          "tokens_per_s": float(said["tokens/s"].replace(",", "")),
          "kv_cache_bytes": int(said["kv_cache_bytes"]),
          "device_peak_bytes": int(said["device_peak_bytes"]),
          "stdout": r.stdout.strip()[-300:], "launches": launches})


def lm_families_path(tmp: Path) -> None:
    """The recurrent, hybrid, M-RoPE and encoder-decoder families on the
    card (module docstring, phase 12h): seven checks, each emitting its
    JSON line.  Checks that no kernel of ``csrc/`` is launched (the path
    has none)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import build_model, get_config, get_family
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.models.encdec import EncDecLM

    dev = torch.device("cuda")
    ops.reset_launches()
    t_phase = time.perf_counter()
    model_class = lambda arch: EncDecLM if get_family(arch) == "encdec" else DecoderLM

    # (a)-(d): each arch at full width and depth through the serving driver
    for check_id, (arch, ctx, prompt, gen_len) in zip("abcd", FAM_SERVE):
        model, cfg = build_model(arch, device=dev)
        resident = fresh_peak()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen, said, wall, stdout = serve_driver(arch, FAM_BATCH, ctx, prompt, gen_len, params)
        peak = torch.cuda.max_memory_allocated()
        check(gen.shape == (FAM_BATCH, gen_len) and gen.min() >= 0 and gen.max() < cfg.vocab,
              f"lm_families ({check_id}) {arch}: generated {gen.shape}, "
              f"range [{gen.min()}, {gen.max()}]")
        ms, cache_bytes = float(said["ms/step"]), int(said["kv_cache_bytes"])
        enc_out_bytes = (FAM_BATCH * cfg.enc_seq * cfg.d_model
                         * torch.finfo(cfg.compute_dtype).bits // 8)
        read = decode_read_bytes(model, params, cache_bytes, enc_out_bytes)
        line = {"phase": "lm_families", "check": check_id, "arch": arch,
                "layers": cfg.n_layers + cfg.enc_layers, "d_model": cfg.d_model,
                "vocab": cfg.vocab, "params": sum(x.numel() for _, x in tree.leaves(params)),
                "dtype": "bf16", "batch": FAM_BATCH, "ctx": ctx, "prompt": prompt,
                "gen": gen_len, "steps": prompt + gen_len - 1, "init_s": init_s,
                "driver_s": wall, "ms_per_step": ms,
                "tokens_per_s": float(said["tokens/s"].replace(",", "")),
                "weight_bytes": tree_bytes(params), "cache_bytes": cache_bytes,
                "step_read_bytes": read, "hbm_share": read / (ms / 1e3) / HBM_BYTES_PER_S,
                "device_peak_bytes": peak, "resident_before_bytes": resident,
                "driver_stdout": stdout[-300:]}
        if cfg.enc_layers:
            line["encode_s"] = float(said["encode_s"])
        if check_id == "a":  # a profiled steady step, as lm_serve (a)
            cache = model.init_cache(FAM_BATCH, ctx, dtype=cfg.compute_dtype)
            steady_ms, prof = profile_decode(make_decode_step(model), params, cache, FAM_BATCH)
            check(prof["device_ops"] > 0, "lm_families (a): the profiler saw no device operation")
            line.update(steady_ms_per_step=steady_ms,
                        steady_hbm_share=read / (steady_ms / 1e3) / HBM_BYTES_PER_S,
                        profiled_step={**prof, "busy_share_of_steady_step":
                                       prof["device_busy_ms"] / steady_ms})
            del cache
        emit(line)
        del params, model

    # (e) decode == prefill in float32 at full width, cut in depth
    worst, t0 = {}, time.perf_counter()
    resident = fresh_peak()
    for arch, layers in FAM_PREFILL_LAYERS.items():
        full = get_config(arch)
        cut = dict(dtype="fp32", remat=False, n_layers=layers, pattern=full.pattern[:layers])
        if full.enc_layers:
            cut["enc_layers"] = layers
        model = model_class(arch)(dataclasses.replace(full, **cut), device=dev)
        cfg = model.cfg
        params = model.init(torch.Generator(device=dev).manual_seed(1))
        rng = np.random.default_rng(1)
        P = FAM_PREFILL
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, P)).astype(np.int32)).to(dev)
        pos = torch.arange(P, dtype=torch.int32, device=dev)
        mrope = cfg.attn is not None and cfg.attn.mrope_sections is not None
        if mrope:  # the t stream in order, h and w as an image's rows and columns would
            pos = torch.from_numpy(np.stack([np.broadcast_to(np.arange(P), (2, P)),
                                             rng.integers(0, P, (2, P)),
                                             rng.integers(0, P, (2, P))], 1).astype(np.int32)
                                   ).to(dev)
        with torch.no_grad():
            if cfg.enc_layers:
                feats = rng.normal(0, 1, (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
                enc_out = model.encode(params, torch.from_numpy(feats).to(dev))
                full_logits, _ = model.decode(params, enc_out, toks, pos)
            else:
                full_logits, _, _ = model.apply(params, toks, pos)
            cache = model.init_cache(2, P, dtype=torch.float32)
            dec = torch.empty_like(full_logits)
            for p in range(P):
                tok = toks[:, p:p + 1]
                if cfg.enc_layers:
                    dec[:, p], cache = model.decode_step(params, cache, enc_out, tok, pos[p])
                elif mrope:
                    dec[:, p], cache = model.decode_step(params, cache, tok, pos[:, :, p:p + 1])
                else:
                    dec[:, p], cache = model.decode_step(params, cache, tok, pos[p])
            rel = float((full_logits - dec).abs().max()) / float(full_logits.abs().max())
        check(bool(torch.isfinite(full_logits).all()) and rel < 2e-3,
              f"lm_families (e) {arch}: decode != prefill, max relative error {rel}")
        worst[arch] = {"layers": f"{layers} of {full.n_layers}" + (
            f" (+ {layers} of {full.enc_layers} encoder)" if full.enc_layers else ""),
                       "max_rel_err": rel}
        del params, cache, full_logits, dec, model
    emit({"phase": "lm_families", "check": "e", "dtype": "fp32", "batch": 2,
          "positions": FAM_PREFILL, "bound": 2e-3, "archs": worst,
          "seconds": time.perf_counter() - t0,
          "device_peak_bytes": torch.cuda.max_memory_allocated(),
          "resident_before_bytes": resident})

    # (f) the reduced configs on the card against the CPU, float32
    worst, t0 = {}, time.perf_counter()
    for arch in FAM_ARCHS:
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="fp32", remat=False)
        models = {"cpu": model_class(arch)(cfg, device="cpu"),
                  "cuda": model_class(arch)(cfg, device=dev)}
        init = models["cpu"].init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab, (2, FAM_CPU_STEPS + 1)).astype(np.int32)
        feats = rng.normal(0, 1, (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        got = {}
        for name, model in models.items():
            on = torch.device(name)
            params = tree.rebuild(init, lambda _, x: x.detach().clone().to(on))
            t = torch.from_numpy(toks).to(on)
            cache = model.init_cache(2, 16, dtype=torch.float32)
            extra = {}
            logits = []
            with torch.no_grad():
                if cfg.enc_layers:
                    extra["enc_out"] = model.encode(params, torch.from_numpy(feats).to(on))
                step = make_decode_step(model)
                for p in range(FAM_CPU_STEPS):
                    lg, cache = step(params, cache, {"token": t[:, p:p + 1], "pos": p, **extra})
                    logits.append(lg.cpu())
            leaves = [x.requires_grad_(True) for _, x in tree.leaves(params)]
            if cfg.enc_layers:
                loss, _ = model.loss(params, torch.from_numpy(feats).to(on), t[:, :-1], t[:, 1:])
            else:
                pos = torch.arange(FAM_CPU_STEPS, device=on)
                if cfg.attn is not None and cfg.attn.mrope_sections is not None:
                    pos = pos[None, None].expand(2, 3, FAM_CPU_STEPS)
                loss, _ = model.loss(params, t[:, :-1], t[:, 1:], pos)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            got[name] = (logits, float(loss.detach()),
                         [None if g is None else g.cpu() for g in grads])
        (la, lossa, ga), (lb, lossb, gb) = got["cpu"], got["cuda"]
        errs = {"decode": max(float((b - a).abs().max()) / float(a.abs().max())
                              for a, b in zip(la, lb)),
                "loss": abs(lossb - lossa) / abs(lossa),
                "grads": max(float((b - a).abs().max()) / (float(a.abs().max()) + 1e-30)
                             for a, b in zip(ga, gb) if a is not None)}
        check(all(e <= 1e-4 for e in errs.values()) and
              [a is None for a in ga] == [b is None for b in gb],
              f"lm_families (f) {arch}: card != CPU: {errs}")
        worst[arch] = errs
    emit({"phase": "lm_families", "check": "f", "dtype": "fp32", "steps": FAM_CPU_STEPS,
          "bound": 1e-4, "max_err_over_max": worst, "seconds": time.perf_counter() - t0})

    # (g) the reduced drivers as subprocesses, all at once
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    runs = {("serve", a): [sys.executable, "-m", "repro_torch.launch.serve", "--arch", a,
                           "--reduced"] for a in FAM_ARCHS}
    runs.update({("train", a): [sys.executable, "-m", "repro_torch.launch.train", "--arch", a,
                                "--reduced", "--steps", "40", "--batch", "4", "--seq", "16",
                                "--lr", "3e-3", "--ckpt-every", "8", "--inject-failure-at",
                                "12", "--ckpt-dir", str(tmp / f"lm_families_{a}")]
                 for a in FAM_TRAIN})
    procs = {k: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, cmd in runs.items()}
    drivers = {}
    for (kind, arch), proc in procs.items():
        out, err = proc.communicate(timeout=600)
        said = dict(kv.split("=", 1) for kv in out.split() if "=" in kv)
        ok = proc.returncode == 0 and ("tokens/s=" in out if kind == "serve" else
                                       said.get("restarts") == "1"
                                       and float(said["loss[-1]"]) < float(said["loss[0]"]))
        check(ok, f"lm_families (g) {kind} {arch}: exit {proc.returncode}: {out[-1000:]} "
                  f"{err[-2000:]}")
        drivers[f"{kind} {arch}"] = out.strip().splitlines()[-1][-200:]
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()), f"lm_families: a codec kernel was launched: {launches}")
    emit({"phase": "lm_families", "check": "g", "seconds": time.perf_counter() - t0,
          "drivers": drivers, "launches": launches,
          "phase_seconds": time.perf_counter() - t_phase})


def dryrun_path(tmp: Path) -> None:
    """LM sharding, microbatching and the dry run on the card (module
    docstring, phase 12i): four checks, each emitting its JSON line."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.steps import TrainOptions, make_train_step
    from repro_torch.launch.train import deterministic, prng_key
    from repro_torch.models.decoder import DecoderLM, default_pattern
    from repro_torch.optim import adamw
    from repro_torch.runtime import reshard_restore

    dev = torch.device("cuda")
    ops.reset_launches()
    # (d) first, in the background: three CPU-bound subprocesses, no card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp / "dryrun"
    t_d = time.perf_counter()
    procs = {f"{arch}:{shape}": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--out", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch, shape in DRY_CELLS}

    # (a) microbatching at full width
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS,
                              pattern=default_pattern(LM_LAYERS, rope_theta=1e4))
    model = DecoderLM(cfg, device=dev)
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, DRY_BATCH, LM_SEQ, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}
               for i in range(DRY_STEPS)]
    tokens = DRY_BATCH * LM_SEQ
    runs, after_one = {}, {}
    with deterministic(dev):
        for M in DRY_MICRO:
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            n_params = sum(p.numel() for _, p in tree.leaves(params))
            step, adam_cfg = make_train_step(model, cfg, TrainOptions(
                lr=LM_LR, warmup=1, total_steps=100, moment_dtype="bf16", microbatch=M))
            opt = adamw.init(params, adam_cfg)
            base = fresh_peak()
            times, losses = [], []
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt, m = step(params, opt, batch, prng_key(i))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                losses.append(float(m["loss"]))
                if i == 0:
                    after_one[M] = {path: p.detach().float().cpu()
                                    for path, p in tree.leaves(params)}
                    lr1 = m["lr"]
            ms = float(np.median(times[1:])) * 1e3
            runs[M] = {"ms_per_step": ms, "first_step_ms": times[0] * 1e3, "losses": losses,
                       "tokens_per_s": tokens / ms * 1e3,
                       "bf16_dense_peak_share": 6 * n_params * tokens / (ms / 1e3)
                       / BF16_OPS_PER_S,
                       "device_peak_bytes": torch.cuda.max_memory_allocated() - base}
            del params, opt, step
    m1, m4 = DRY_MICRO
    check(all(np.isfinite(r["losses"]).all() for r in runs.values()),
          f"dryrun (a): losses {[r['losses'] for r in runs.values()]}")
    loss_rel = abs(runs[m4]["losses"][0] - runs[m1]["losses"][0]) / abs(runs[m1]["losses"][0])
    check(loss_rel <= 2e-3, f"dryrun (a): step-1 loss M={m4} vs M={m1}: rel {loss_rel}")
    pmax = max(float(p.abs().max()) for p in after_one[m1].values())
    pdiff = max(float((after_one[m4][k] - after_one[m1][k]).abs().max()) for k in after_one[m1])
    ptol = 2.0 ** -7 * pmax + 2 * lr1  # two bfloat16 ulps of max|p|, or an update's sign
    check(pdiff <= ptol, f"dryrun (a): parameters after one step differ by {pdiff} > {ptol}")
    check(runs[m4]["device_peak_bytes"] < runs[m1]["device_peak_bytes"],
          f"dryrun (a): peak at M={m4} not below M={m1}: "
          f"{runs[m4]['device_peak_bytes']} vs {runs[m1]['device_peak_bytes']}")
    emit({"phase": "dryrun", "check": "a", "arch": LM_ARCH, "layers": f"{LM_LAYERS} of 40",
          "params": n_params, "batch": DRY_BATCH, "seq": LM_SEQ, "moments": "bf16",
          "steps": DRY_STEPS, "runs": runs, "loss_rel_diff": loss_rel,
          "param_max_diff": pdiff, "param_tol": ptol, "max_abs_param": pmax})
    del after_one

    # (b) the sharded path on a one-rank NCCL group
    rcfg = dataclasses.replace(get_config(LM_ARCH, reduced=True), dtype="fp32")
    rmodel = DecoderLM(rcfg, device=dev)
    init = rmodel.init(torch.Generator(device=dev).manual_seed(3))
    rpipe = TokenPipeline(TokenPipelineConfig(rcfg.vocab, 4, 16, seed=1))
    rbatch = {k: torch.from_numpy(v).to(dev) for k, v in rpipe.batch_at(0).items()}
    opts = TrainOptions(lr=1e-3, warmup=1, total_steps=10, moment_dtype="fp32", microbatch=2)
    mesh = make_host_mesh()
    try:
        specs = SH.param_pspecs(init, SH.ShardingOptions(fsdp=True), mesh)
        plain = tree.rebuild(init, lambda _, t: t.detach().clone())
        step, adam_cfg = make_train_step(rmodel, rcfg, opts)
        plain_opt = adamw.init(plain, adam_cfg)
        plain, _, pm = step(plain, plain_opt, rbatch, prng_key(0))
        placed = SH.distribute(tree.rebuild(init, lambda _, t: t.detach().clone()), mesh, specs)
        dstep, _ = make_train_step(rmodel, rcfg, opts, mesh=mesh)
        popt = adamw.init(placed, adam_cfg)  # the moments take their parameters' placements
        placed, _, dm = dstep(placed, popt, SH.distribute(rbatch, mesh, {
            k: SH.batch_pspec(mesh) for k in rbatch}), prng_key(0))
        with torch.no_grad():
            worst = max(float((d.full_tensor() - p).abs().max() / p.abs().max().clamp(min=1e-30))
                        for (_, d), (_, p) in zip(tree.leaves(placed), tree.leaves(plain)))
        loss_diff = abs(float(dm["loss"].full_tensor()) - float(pm["loss"]))
        check(worst <= 1e-5 and loss_diff <= 1e-5 * abs(float(pm["loss"])),
              f"dryrun (b): sharded step vs plain: {worst} of the largest, loss {loss_diff}")
        mgr = CheckpointManager(str(tmp / "dry_ckpt"), async_save=False)
        mgr.save(1, init)
        target = tree.rebuild(init, lambda _, t: torch.zeros_like(t))
        back = reshard_restore(mgr, target, mesh, opts=SH.ShardingOptions(fsdp=True))
        named = SH.named(mesh, specs)
        for (path, b), (_, want) in zip(tree.leaves(back), tree.leaves(init)):
            check(b.placements == tree.get(named, path) and torch.equal(b.full_tensor(), want),
                  f"dryrun (b): reshard_restore at {path}")
        emit({"phase": "dryrun", "check": "b", "mesh": mesh_str(mesh), "microbatch": 2,
              "leaves": len(list(tree.leaves(init))), "max_rel_diff": worst,
              "loss_diff": loss_diff, "restored_bit_equal": True})

        # (c) the roofline of (a)'s own cell against its measured step
        info = dryrun.trace_cell(LM_ARCH, "train_4k", False, mesh=mesh, cfg=cfg,
                                 cell=ShapeCell("train_2k_b8", LM_SEQ, DRY_BATCH, "train"),
                                 overrides={"microbatch": 1, "fsdp": False,
                                            "moment_dtype": "bf16"})
    finally:
        dist.destroy_process_group()
    row = roofline.analyse(info)
    terms = {k: row[f"t_{k}_s"] * 1e3 for k in ("compute", "memory", "collective")}
    measured = runs[m1]["ms_per_step"]
    emit({"phase": "dryrun", "check": "c", "counted_flops": info["walked"]["flops"],
          "model_flops_6nd": row["model_flops"], "counted_over_6nd": 1 / row["useful_fraction"],
          "terms_ms": terms, "dominant": row["dominant"],
          "measured_ms_m1": measured, "measured_over_dominant": measured / terms[row["dominant"]],
          "trace_s": info["trace_s"], "static_bytes": info["static_bytes_per_dev"]})

    # (d) the production dry run's three cells, then the roofline table
    said = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=900)
        said[name] = so.strip().splitlines()[-2:]
        check(p.returncode == 0, f"dryrun (d): {name} exited {p.returncode}: {so[-800:]} "
                                 f"{se[-1500:]}")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dir", str(out),
                        "--mesh", "all", "--json-out", str(out / "roofline.json")], env=env,
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0 and "ERROR" not in r.stdout,
          f"dryrun (d): roofline exited {r.returncode}: {r.stdout[-1500:]} {r.stderr[-1500:]}")
    rows = json.loads((out / "roofline.json").read_text())
    check(len(rows) == len(DRY_CELLS), f"dryrun (d): {len(rows)} rows of {len(DRY_CELLS)}")
    print(r.stdout, flush=True)
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()), f"dryrun: a codec kernel launched: {launches}")
    emit({"phase": "dryrun", "check": "d", "seconds": time.perf_counter() - t_d,
          "cells": said, "rows": [{k: v for k, v in row.items() if k != "settings"}
                                  for row in rows], "launches": launches})


def mesh_str(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape) + f" {mesh.device_type}"


def legacy_inputs(blob: bytes, dev):
    """The boundary pass's inputs for a legacy hf/hz blob: (args, kw, total
    bits); the kernel and its plain version take the same ones."""
    import struct
    import zlib

    from repro_torch.sz import entropy

    n, tlen = struct.unpack_from("<QI", blob, 6)
    codec = entropy._cached_codec(bytes(blob[18 : 18 + tlen]))
    body = blob[18 + tlen :]
    if blob[4:6] == b"hz":
        body = zlib.decompress(body)
    (total,) = struct.unpack_from("<Q", body, 0)
    tabs = codec._tables_on(dev)
    words = entropy._stream_words(body[8:], 0, None, dev)
    return ((words, tabs.cw_map, tabs.len_sorted),
            dict(n_symbols=n, chunk_size=entropy.DEFAULT_CHUNK), total)


def legacy_row(rows: dict, par: Parity, blob: bytes, case: str, dev) -> None:
    """Parity and timing of the boundary pass on one legacy blob (CUDA
    events around each launch: a launch is several kernels); the bound is
    the stream's words read and the offsets written over the HBM rate, and
    one operation a symbol."""
    from repro_torch.kernels import huffman_legacy, ref

    args, kw, total = legacy_inputs(blob, dev)
    got = huffman_legacy.huffman_legacy_bounds(*args, **kw)
    par.compare("huffman_legacy", case, got, ref.huffman_legacy_bounds_ref(*args, **kw))
    check(int(got[-1]) == total, f"huffman_legacy [{case}] ends at {int(got[-1])}, not {total}")
    nbytes = 4 * -(-total // 32) + 8 * got.numel()
    time_row(rows, "huffman_legacy", lambda: huffman_legacy.huffman_legacy_bounds(*args, **kw),
             lambda: ref.huffman_legacy_bounds_ref(*args, **kw), nbytes, kw["n_symbols"],
             reps=20, plain_reps=2, timer=launch_events_ms)
    rows["huffman_legacy"]["shape_note"] = (f"{kw['n_symbols']} symbols, {total} bits, "
                                            f"{got.numel() - 1} chunks, {blob[4:6].decode()}")


def legacy_path(par: Parity, x_np, art) -> tuple[dict, dict]:
    """The entropy codec's read leftovers on the card: legacy hf/hz blobs of
    the main field's 512 lane codes and of one whole 128^3 stream (bytes
    equal to the CPU route's on a stride of lanes and on the stream), their
    decode (boundary pass, then the chunked decode), range reads equal to
    the full decode's slice; the boundary pass held against its plain
    version on edge cases and timed.  Returns (launches, kernel rows)."""
    import numpy as np
    import torch

    from repro_torch.kernels import huffman_legacy, lorenzo_quant, ops, ref
    from repro_torch.sz import entropy, tiled

    dev = torch.device("cuda")
    x = torch.from_numpy(x_np).to(dev)
    tiles = tiled.split_tiles(tiled.pad_to_tiles(x, TILE), TILE).contiguous()
    lanes = lorenzo_quant.lorenzo_quant_tiles(tiles, art.eb_abs).reshape(tiles.shape[0], -1)
    stream = lorenzo_quant.lorenzo_quant(x[:128, :128, :128].contiguous(),
                                         art.eb_abs).reshape(-1)
    del x, tiles
    L, n = lanes.shape
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    lane_blobs = [entropy.encode_codes_legacy(lanes[i], BACKEND) for i in range(L)]
    stream_blob = entropy.encode_codes_legacy(stream, "huffman")
    t1 = time.perf_counter()
    bad = [i for i, b in enumerate(lane_blobs)
           if not torch.equal(entropy.decode_codes(b, (n,), device=dev), lanes[i])]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(entropy.decode_codes(stream_blob, (stream.numel(),), device=dev), stream),
          "the legacy 128^3 stream decoded wrong on the card")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    check(not bad, f"legacy lanes {bad[:8]} decoded wrong on the card")
    check(all(launches[k] == L + 1 for k in LEGACY_KERNELS),
          f"the legacy path did not launch each kernel once a blob: {launches}")
    stride = 8
    check(all(entropy.encode_codes_legacy(lanes[i].cpu(), BACKEND) == lane_blobs[i]
              for i in range(0, L, stride)), "card and CPU legacy lane bytes differ")
    check(entropy.encode_codes_legacy(stream.cpu(), "huffman") == stream_blob,
          "card and CPU legacy stream bytes differ")
    median = int(np.argsort([len(b) for b in art.tile_blobs])[L // 2])
    check(torch.equal(entropy.decode_codes(art.tile_blobs[median], (n,), device=dev),
                      lanes[median]), "the container's lane holds other codes")
    ranges = {"lane_hZ": art.tile_blobs[median], "lane_hz": lane_blobs[median],
              "stream_hc": entropy.encode_codes(stream, "huffman"), "stream_hf": stream_blob}
    spans = {}
    for name, blob in ranges.items():
        full = entropy.decode_codes(blob, (-1,), device=dev)
        m = full.numel()
        cuts = [(0, m), (0, 0), (255, 257), (256, 512), (m - 1, m), (1000, min(m, 99_999)),
                (m // 3, m // 3 + 77)]
        for lo, hi in cuts:
            check(torch.equal(entropy.decode_codes_range(blob, lo, hi, device=dev),
                              full[lo:hi]), f"range [{lo}, {hi}) of {name} != the slice")
        spans[name] = len(cuts)
    rows = {}
    rng = np.random.default_rng(7)
    sizes = [2**i for i in range(18, 0, -1)] + [1, 1]
    escape = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    rng.shuffle(escape)
    edges = {"escape_codes": escape,
             "wide_alphabet": rng.integers(-5000, 5000, 300_000).astype(np.int32),
             "one_symbol": np.full(1000, -3, np.int32),
             "short": rng.integers(-3, 4, 100).astype(np.int32)}
    edge_bits = {}
    for case, codes in edges.items():
        blob = entropy.encode_codes_legacy(torch.from_numpy(codes).to(dev), "huffman")
        args, kw, total = legacy_inputs(blob, dev)
        par.compare("huffman_legacy", case, huffman_legacy.huffman_legacy_bounds(*args, **kw),
                    ref.huffman_legacy_bounds_ref(*args, **kw))
        edge_bits[case] = total
    legacy_row(rows, par, lane_blobs[median], "main_lane", dev)
    srows = {}
    legacy_row(srows, par, stream_blob, "stream_128^3", dev)
    s_row = srows["huffman_legacy"]
    rows["huffman_legacy"]["stream"] = {"shape": s_row.pop("shape_note"), **s_row}
    r = rows["huffman_legacy"]
    emit({"phase": "legacy", "lanes": L, "lane_symbols": n, "stream_symbols": stream.numel(),
          "backends": {"lanes": BACKEND, "stream": "huffman"},
          "encode_s": t1 - t0, "lane_decode_s": t2 - t1, "stream_decode_s": t3 - t2,
          "lane_blob_bytes": sum(len(b) for b in lane_blobs),
          "stream_blob_bytes": len(stream_blob), "cpu_bytes_checked_lanes": len(range(0, L, stride)),
          "range_cuts": spans, "edge_case_bits": edge_bits,
          "bounds_ms": {"lane": r["ms"], "stream": r["stream"]["ms"]},
          "bound_ms": {"lane": r["bound_ms"], "stream": r["stream"]["bound_ms"]},
          "launches": launches})
    return launches, rows


def serve_path(tmp: Path, main_art, gw_art, szjx_file: Path) -> dict:
    """The serving daemon on the card: one RegionServer on 127.0.0.1:0 over
    the enhanced tiled gwlz volume, the main Lorenzo volume and the szjx
    file, in one pool sharing one cache; a storm of SERVE_CLIENTS client
    threads x SERVE_REQUESTS requests over a seeded pool of SERVE_ROIS
    overlapping ROIs (1-8 lanes inside one 4x4x4-lane block; every eighth a
    monolithic crop).  Checks: every body equals np.save of the crop of an
    eager full decode through a separate handle; the shared cache's hit rate
    >= 0.5; a repeat with the ETag gets 304 and no decode; an in-process
    hammer of single-lane reads makes at least 2x fewer decode dispatches
    with the batcher than without.  Returns the storm's launches."""
    import hashlib
    import io
    import threading
    from urllib.request import urlopen

    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.exec.cache import DecodeBatcher, TileCache
    from repro_torch.kernels import ops
    from repro_torch.serve import RegionServer, fetch_json, fetch_region
    from repro_torch.sz import tiled

    files = {"gwlz": tmp / "serve_gwlz.gwtc", "main": tmp / "serve_main.gwtc", "szjx": szjx_file}
    files["gwlz"].write_bytes(gw_art.to_bytes())
    files["main"].write_bytes(main_art.to_bytes())
    full = {}
    for name, f in files.items():
        with api.open(f) as v:
            full[name] = np.asarray(v).copy()
    rng = np.random.default_rng(0)
    grid = [s // t for s, t in zip(SHAPE, TILE)]
    block = [4 * int(rng.integers(0, g // 4)) for g in grid]  # lanes, a 4x4x4 block's origin
    rois = []
    for j in range(SERVE_ROIS):
        name = "szjx" if j % 8 == 7 else ("gwlz", "main")[j % 2]
        bounds = []
        for d, t in enumerate(TILE):
            ext = int(rng.integers(1, 3))
            first = block[d] + int(rng.integers(0, 5 - ext))
            lo = first * t + int(rng.integers(0, t))
            last_lo = (first + ext - 1) * t
            hi = int(rng.integers(max(lo, last_lo) + 1, last_lo + t + 1))
            bounds.append((lo, hi))
        rois.append((name, ",".join(f"{a}:{b}" for a, b in bounds),
                     tuple(slice(a, b) for a, b in bounds)))
    want = []
    for name, _spec, sl in rois:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(full[name][sl]))
        want.append(hashlib.sha256(buf.getvalue()).hexdigest())

    with RegionServer(files, cache_bytes=SERVE_BUDGET, mem_budget=SERVE_BUDGET,
                      batch_wait_ms=SERVE_WAIT_MS) as srv:
        results, errors, lock = [], [], threading.Lock()
        gate = threading.Barrier(SERVE_CLIENTS)

        def client(c: int) -> None:
            picks = np.random.default_rng(1000 + c).integers(0, SERVE_ROIS, SERVE_REQUESTS)
            try:
                gate.wait()
                for j in picks:
                    name, spec, _sl = rois[j]
                    t = time.perf_counter()
                    with urlopen(f"{srv.url}/v/{name}/region?roi={spec}", timeout=300) as r:
                        body = r.read()
                    ms = (time.perf_counter() - t) * 1e3
                    digest = hashlib.sha256(body).hexdigest()
                    with lock:
                        results.append((int(j), digest, ms))
            except Exception as e:  # surfaced below
                with lock:
                    errors.append(repr(e))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tiled.reset_dispatch_stats()
        ops.reset_launches()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        m = fetch_json(srv.url, "/metrics")
        check(not errors, f"serve: {len(errors)} requests failed: {errors[:3]}")
        check(len(results) == SERVE_CLIENTS * SERVE_REQUESTS, "serve: requests went missing")
        wrong = sorted({j for j, digest, _ms in results if digest != want[j]})
        check(not wrong, f"serve: ROIs {wrong} were served bytes other than the eager crop")
        check(m["cache"]["hit_rate"] >= 0.5, f"serve: hit rate {m['cache']['hit_rate']} < 0.5")
        check(all(launches[k] > 0 for k in SERVE_KERNELS), f"serve: a kernel never ran: {launches}")
        check(m["errors"] == 0 and m["admission"]["rejected"] == 0, "serve: errors or 503s")
        # ETag revalidation: 304, and no decode work at all
        name, spec, _sl = rois[0]
        _arr, meta = fetch_region(srv.url, name, spec)
        before = (tiled.dispatch_stats()["dispatches"], dict(ops.LAUNCHES))
        again, meta2 = fetch_region(srv.url, name, spec, etag=meta["etag"])
        torch.cuda.synchronize()
        check(again is None and meta2["etag"] == meta["etag"], "serve: no 304 on the ETag")
        check((tiled.dispatch_stats()["dispatches"], dict(ops.LAUNCHES)) == before,
              "serve: a 304 ran decode work")
        lat = np.array([ms for _j, _d, ms in results])
        by_volume = {v: np.array([ms for j, _d, ms in results if rois[j][0] == v])
                     for v in files}

    # the in-process hammer: single-lane reads, batcher off then on
    art = tiled.TiledCompressed.from_bytes(files["main"].read_bytes())
    lane_rois = [tuple(slice(a * t, (a + 1) * t) for a, t in zip(pos, TILE))
                 for pos in np.ndindex(*grid)]
    hammer = {}
    for mode in ("off", "on"):
        batcher = None if mode == "off" else DecodeBatcher(max_wait_ms=20.0,
                                                           max_batch_tiles=4096)
        vol = api.CompressedVolume(art, tile_cache=TileCache(SERVE_BUDGET), cache_ns="cmp",
                                   decode_batcher=batcher)
        bad = []
        gate = threading.Barrier(SERVE_CLIENTS)

        def reader(i: int) -> None:
            roi = lane_rois[i % len(lane_rois)]
            gate.wait()
            if not np.array_equal(vol[roi], full["main"][roi]):
                with lock:
                    bad.append(i)

        before = tiled.dispatch_stats()["dispatches"]
        threads = [threading.Thread(target=reader, args=(i,)) for i in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        hammer[mode] = {"dispatches": tiled.dispatch_stats()["dispatches"] - before,
                        "mismatches": len(bad)}
        if batcher is not None:
            hammer[mode]["batcher"] = batcher.info()
        vol.close()
        check(not bad, f"hammer ({mode}): reads {bad[:5]} differ from the eager decode")
    off, on = hammer["off"]["dispatches"], hammer["on"]["dispatches"]
    check(on * 2 <= off, f"the batcher cut dispatches only {off} -> {on}; need >= 2x")
    b = m["batcher"]
    emit({"phase": "serve", "volumes": {k: str(v.name) for k, v in files.items()},
          "clients": SERVE_CLIENTS, "requests_each": SERVE_REQUESTS, "rois": SERVE_ROIS,
          "roi_block_lanes": block, "cache_bytes": SERVE_BUDGET, "mem_budget": SERVE_BUDGET,
          "batch_wait_ms": SERVE_WAIT_MS, "wall_s": wall,
          "req_per_s": len(results) / wall,
          "client_ms": {"p50": float(np.percentile(lat, 50)),
                        "p99": float(np.percentile(lat, 99)), "max": float(lat.max())},
          "client_ms_by_volume": {v: {"requests": int(a.size),
                                      "p50": float(np.percentile(a, 50)),
                                      "p99": float(np.percentile(a, 99))}
                                  for v, a in by_volume.items() if a.size},
          "server_ms": m["latency_ms"], "hit_rate": m["cache"]["hit_rate"],
          "cache": m["cache"], "batcher": {k: b[k] for k in ("submits", "dispatches",
                                                             "coalesced_submits",
                                                             "peak_pending_tiles",
                                                             "batch_hist")},
          "admission": m["admission"], "decode": m["decode"], "lanes_served": m["lanes_served"],
          "storm_launches": launches, "device_peak_bytes": peak,
          "etag_304_without_decode": True, "hammer": hammer,
          "dispatch_reduction": off / on if on else None})
    return launches


def time_row(rows, name, kern, plain, nbytes, nops, library=None, reps=200, plain_reps=20,
             timer=None):
    """Time kernel, plain version and library call; store the row with its
    bound (the larger of bytes over HBM rate and operations over the
    float32 rate).  ``timer`` times the kernel (default: the profiler)."""
    ms, ms_by = (timer or functools.partial(kernel_ms, kernel=KERNELS[name][2]))(kern,
                                                                               reps=reps)
    rows[name] = {
        "ms": ms, "ms_by": ms_by, "call_ms": events_ms(kern, reps),
        "plain_ms": events_ms(plain, plain_reps),
        "library_ms": None if library is None else events_ms(library, reps),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S
        else "operations",
        "shape_note": None}


def enhancer_flop(n: int, ids, live, C: int) -> tuple[int, float]:
    """Operations the group-wise enhancer needs on ``n`` pixels of slices
    whose groups are ``ids`` ([B, H, W] int32; None: all group 0), when only
    the groups in ``live`` have an output: 2 flop for each FMA.  A hidden
    value h_g(q) (9 taps x C channels of FMAs) is needed once for every
    in-slice pixel q and group g that some pixel of q's 3x3 neighbourhood
    belongs to; each output pixel of a live group adds the 9C FMAs of conv2.
    Returns (flop, hidden values needed per pixel)."""
    import torch
    import torch.nn.functional as F

    if ids is None:
        n_h = n_out = n
    else:
        n_h = n_out = 0
        for g in live:
            m = (ids == g)[:, None].to(torch.float32)
            n_out += int(torch.count_nonzero(m))
            n_h += int(torch.count_nonzero(F.max_pool2d(m, 3, stride=1, padding=1)))
            del m
    return 2 * 9 * C * (n_h + n_out), n_h / n


def tile_slices(gw_art):
    """Every decoded tile of a tiled artifact as one stack of slices."""
    from repro_torch.sz.tiled import decode_lanes

    recon, _ = decode_lanes(gw_art, range(gw_art.n_tiles))
    return recon.reshape((-1,) + tuple(TILE[1:])).contiguous()


def gwlz_kernel_rows(par: Parity, xs, model, case: str, mode: str, with_g1: bool) -> dict:
    """Parity and timing of group_hist and enhancer_fused on the decoded
    slices ``xs`` [B, H, W], with the trained model's edges and table: the
    enhanced full decode's launch (``mode="residual"``) or the gate's
    (``"pred"``, every group with an output).  ``with_g1`` adds the TPU
    kernel's own G = 1 contract on the same slices."""
    import torch

    from repro_torch.core import enhancer
    from repro_torch.kernels import enhancer_fused, group_hist, ref

    rows = {}
    row = functools.partial(time_row, rows)
    edges = model.edges
    G = edges.numel() - 1
    ids, hist = group_hist.group_hist(xs, edges)
    par.compare("group_hist", f"{case}_decode", (ids, hist), ref.group_hist_ref(xs, edges))
    bounds = edges[1:-1].contiguous()
    n = xs.numel()
    # bytes: read x, write ids (+ edges, hist); operations: G compares a value
    row("group_hist", lambda: group_hist.group_hist(xs, edges),
        lambda: ref.group_hist_ref(xs, edges), 8 * n + 8 * G + 4, G * n,
        library=lambda: torch.bincount(torch.bucketize(xs, bounds, right=True).reshape(-1),
                                       minlength=G), reps=20, plain_reps=2)
    filled = int((hist > 0).sum())
    rows["group_hist"]["shape_note"] = (f"x {list(xs.shape)} f32, {G} groups, "
                                        f"{filled} holding values")

    packed = model.packed()
    C = enhancer.DEFAULT_CHANNELS
    # held in prediction units (the residual epilogue adds x, which would
    # swamp a relative tolerance); then the residual output to the same
    # bound scaled by rscale, plus the rounding of x + rhat
    got = enhancer_fused.enhancer_grouped(xs, ids, packed, mode="pred")
    want = ref.enhancer_grouped_ref(xs, ids, packed, mode="pred")
    par.compare_float("enhancer_fused", f"{case}_decode_pred", got, want, ENHANCE_RTOL)
    tol = ENHANCE_RTOL * (1 + float(want.abs().max())) * float(model.rscale.max())
    del got, want
    if mode == "residual":
        got = enhancer_fused.enhancer_grouped(xs, ids, packed, mode=mode)
        diff = (got - ref.enhancer_grouped_ref(xs, ids, packed, mode=mode)).abs()
        check(bool((diff <= tol + torch.abs(xs) * 2**-23).all()),
              f"enhancer_fused [{case}] residual output off by {float(diff.max())} "
              f"(tolerance {tol})")
        del got, diff
    # bytes: read x and ids, write out (+ the table); operations: what this
    # run's ids need, where in residual mode only the groups with rscale > 0
    # have an output (elsewhere out = x) and in pred mode every group has
    live = [g for g in range(G) if mode == "pred" or float(model.rscale[g]) > 0]
    flop, h_per_px = enhancer_flop(n, ids, live, C)
    row("enhancer_fused", lambda: enhancer_fused.enhancer_grouped(xs, ids, packed, mode=mode),
        lambda: ref.enhancer_grouped_ref(xs, ids, packed, mode=mode),
        12 * n + 4 * packed.numel(), flop, reps=10, plain_reps=1, timer=launch_events_ms)
    launch = "the enhanced full decode's" if mode == "residual" else "the gate's"
    rows["enhancer_fused"]["shape_note"] = (
        f"x/ids {list(xs.shape)}, G={G}, C={C}, {len(live)} groups with an output, "
        f"{filled} holding values, {mode} ({launch} launch); {h_per_px:.4f} hidden values "
        f"needed per pixel")
    rows["enhancer_fused"]["flop"] = flop
    if not with_g1:
        return rows
    del ids
    # the TPU kernel's own contract, G = 1, on the same slices scaled to
    # [0, 1] (its inputs are normalised); its library yardstick is one cuDNN
    # conv -> affine -> relu -> conv in float32
    xs = ((xs - xs.min()) / (xs.max() - xs.min())).contiguous()
    p1 = {k: v[0] for k, v in model.params.items()}
    s1 = {k: v[0] for k, v in model.bn_state.items()}
    single = enhancer_fused.single_enhancer(p1["w1"], p1["b1"], p1["gamma"], p1["beta"],
                                            s1["mean"], s1["var"], p1["w2"], p1["b2"])
    par.compare_float("enhancer_fused", "G1_gwlz_slices",
                      enhancer_fused.enhancer_grouped(xs, None, single, mode="pred"),
                      ref.enhancer_fused_ref(xs, p1["w1"], p1["b1"], p1["gamma"], p1["beta"],
                                             s1["mean"], s1["var"], p1["w2"], p1["b2"]),
                      ENHANCE_RTOL)
    bn_scale, bn_shift = enhancer_fused.fold_bn(p1["gamma"], p1["beta"], s1["mean"],
                                                s1["var"])
    wc1 = p1["w1"].permute(3, 2, 0, 1).contiguous()  # [C, 1, 3, 3]
    wc2 = p1["w2"].permute(3, 2, 0, 1).contiguous()  # [1, C, 3, 3]

    def library_g1():
        import torch.nn.functional as F

        with enhancer.fp32_convs():
            h = F.conv2d(xs[:, None], wc1, p1["b1"], padding=1)
            h = torch.relu(h * bn_scale[None, :, None, None] + bn_shift[None, :, None, None])
            return F.conv2d(h, wc2, p1["b2"], padding=1)[:, 0]

    g1_ms, g1_by = launch_events_ms(lambda: enhancer_fused.enhancer_grouped(
        xs, None, single, mode="pred"), 10)
    g1_flop, _ = enhancer_flop(n, None, [0], C)
    rows["enhancer_fused"]["g1"] = {
        "shape": f"x {list(xs.shape)}, G=1, C={C}", "ms": g1_ms, "ms_by": g1_by,
        "plain_ms": events_ms(lambda: ref.enhancer_fused_ref(
            xs, p1["w1"], p1["b1"], p1["gamma"], p1["beta"], s1["mean"], s1["var"],
            p1["w2"], p1["b2"]), 1),
        "library_ms": events_ms(library_g1, 10),
        "bound_ms": max(8 * n / HBM_BYTES_PER_S, g1_flop / FP32_OPS_PER_S) * 1e3,
        "bound_by": "operations" if g1_flop / FP32_OPS_PER_S > 8 * n / HBM_BYTES_PER_S
        else "bytes", "flop": g1_flop}
    return rows


def lane_kernel_rows(par: Parity, rows: dict, lanes, case: str, note: str) -> None:
    """Parity and timing of symbol_hist and huffman_encode as the entropy
    stage launches them on the int32 lanes [L, n]: once each for all lanes
    (``entropy.encode_codes_lanes``; a single stream is L = 1)."""
    import numpy as np
    import torch

    from repro_torch.kernels import group_hist, huffman_encode, ref
    from repro_torch.sz import entropy

    L, n = lanes.shape
    lo, hi = torch.aminmax(lanes, dim=1)
    lo_h, hi_h = torch.stack([lo, hi]).cpu().numpy().astype(np.int64)
    span = hi_h - lo_h + 1
    nb = int(span.max())
    check(nb <= entropy._LANES_SPAN, f"{case}: a lane spans {nb} values, past the batch")
    par.compare("symbol_hist", case, group_hist.symbol_hist_lanes(lanes, lo, nb),
                ref.symbol_hist_lanes_ref(lanes, lo, nb))
    # the library call: one bincount of each symbol's bin in a flat [L * nb]
    # histogram (those bins computed beforehand)
    flat_bins = (lanes.to(torch.int64) - lo.to(torch.int64)[:, None]
                 + nb * torch.arange(L, device=lanes.device)[:, None]).reshape(-1)
    # bytes: read codes and lo, write the histograms; operations: one a symbol
    time_row(rows, "symbol_hist", lambda: group_hist.symbol_hist_lanes(lanes, lo, nb),
             lambda: ref.symbol_hist_lanes_ref(lanes, lo, nb), 4 * L * n + 4 * L + 4 * L * nb,
             L * n, library=lambda: torch.bincount(flat_bins, minlength=L * nb), reps=50,
             plain_reps=2)
    rows["symbol_hist"]["shape_note"] = f"codes [{L}, {n}] i32, {nb} bins a lane, {note}"
    del flat_bins
    _, lens, cws = entropy._lanes_pack_inputs(lanes, lo, lo_h, span, entropy.DEFAULT_CHUNK)
    par.compare("huffman_encode", case, huffman_encode.huffman_encode_pack(lens, cws),
                ref.huffman_encode_ref(lens, cws))
    C, cs = lens.shape
    # bytes: read lens + codes, write words + chunk_bits; ~12 int ops a symbol
    time_row(rows, "huffman_encode", lambda: huffman_encode.huffman_encode_pack(lens, cws),
             lambda: ref.huffman_encode_ref(lens, cws), 12 * C * cs + 4 * C, 12 * C * cs,
             reps=50, plain_reps=1)
    rows["huffman_encode"]["shape_note"] = f"lens/codes [{C}, {cs}] i32, {note}"


def parent_lorenzo():
    """The parent tree's Lorenzo kernels (``PARENT``), built from its source
    with this tree's nvcc flags, as two callables ``(x, eb, out)`` of the
    same C entry points, keyed as ``PARENT_LORENZO``; None without a
    parent tree."""
    import ctypes

    import torch

    from repro_torch.kernels import _build, lorenzo_quant
    from repro_torch.kernels.ref import two_eb_f32

    src = PARENT / "src" / "repro_torch" / "csrc" / "lorenzo_quant.cu"
    if not src.exists():
        return None
    lib_path = _build.BUILD_DIR / "parent_liblorenzo_quant.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    tiles, volume = lib.lorenzo_quant_tiles, lib.lorenzo_quant_volume
    tiles.argtypes, volume.argtypes = lorenzo_quant._ARGTYPES, lorenzo_quant._VOLUME_ARGTYPES
    tiles.restype = volume.restype = ctypes.c_int

    def call(fn, shape_args):
        def run(x, eb, out):
            err = fn(x.data_ptr(), out.data_ptr(), *shape_args(x), two_eb_f32(eb),
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"the parent's {fn.__name__} failed: cudaError {err}")
        return run

    return {"lorenzo_quant_tiles": call(tiles, lambda x: tuple(x.shape)),
            "lorenzo_quant": call(volume, lambda x: tuple(x.shape))}


def parent_row(rows: dict, name: str, parent, x, eb, want) -> None:
    """Check the parent's kernel ``name`` on ``x`` against this tree's output
    ``want`` and time it as this tree's row was (its own device time)."""
    import torch

    out = torch.empty_like(want)
    parent[name](x, eb, out)
    torch.cuda.synchronize()
    check(torch.equal(out, want), f"the parent's {name} differs from this tree's")
    ms, ms_by = kernel_ms(lambda: parent[name](x, eb, out), PARENT_LORENZO[name], reps=20)
    rows[name]["parent"] = {"ms": ms, "ms_by": ms_by, "source": str(PARENT.relative_to(ROOT))}


def kernel_rows(par: Parity, x_np, art, path_launches: dict, gw: dict, sz_art,
                mono, legacy_rows: dict) -> list[dict]:
    """Parity and timing of each kernel on its path's own shapes
    (``path_launches``: path -> launches of its run); the enhancer's
    kernels on both gwlz runs (``gw``: phase -> (art, model, launches)), the
    second as each row's ``all_groups``; lorenzo_quant on the szjx path
    (``sz_art``); symbol_hist and huffman_encode over all 512 lanes in one
    launch each; and symbol_hist, huffman_encode, huffman_decode and
    enhancer_fused also at the monolithic shapes (``mono``: the szjx stream;
    the gwlz_mono (art, model, launches)); ``legacy_rows``: the boundary
    pass's row, measured in the legacy phase."""
    import numpy as np
    import torch

    from repro_torch.kernels import huffman_decode, lorenzo_quant, ref
    from repro_torch.sz import entropy, tiled

    dev = torch.device("cuda")
    x = torch.from_numpy(x_np).to(dev)
    tiles = tiled.split_tiles(tiled.pad_to_tiles(x, TILE), TILE).contiguous()
    eb = art.eb_abs
    sizes = [len(b) for b in art.tile_blobs]
    lane = int(np.argsort(sizes)[len(sizes) // 2])  # the median-size lane
    rows = dict(legacy_rows)

    row = functools.partial(time_row, rows)

    codes = lorenzo_quant.lorenzo_quant_tiles(tiles, eb)
    par.compare("lorenzo_quant_tiles", "main_512x64^3", codes,
                ref.lorenzo_quant_tiles_ref(tiles, eb))
    n = tiles.numel()
    # bytes: read x, write codes; operations: 1 division + 7 adds per element
    row("lorenzo_quant_tiles", lambda: lorenzo_quant.lorenzo_quant_tiles(tiles, eb),
        lambda: ref.lorenzo_quant_tiles_ref(tiles, eb), 8 * n, 8 * n, reps=20, plain_reps=5)
    rows["lorenzo_quant_tiles"]["shape_note"] = f"x {list(tiles.shape)} f32"
    parent = parent_lorenzo()
    if parent:
        parent_row(rows, "lorenzo_quant_tiles", parent, tiles, eb, codes)

    vcodes = lorenzo_quant.lorenzo_quant(x, eb)
    par.compare("lorenzo_quant", "szjx_512^3", vcodes, ref.lorenzo_quant_ref(x, eb))
    n = x.numel()
    # bytes: read x, write codes; operations: 1 division + 7 adds per element
    row("lorenzo_quant", lambda: lorenzo_quant.lorenzo_quant(x, eb),
        lambda: ref.lorenzo_quant_ref(x, eb), 8 * n, 8 * n, reps=20, plain_reps=5)
    rows["lorenzo_quant"]["shape_note"] = f"x {list(x.shape)} f32, whole volume"
    if parent:
        parent_row(rows, "lorenzo_quant", parent, x, eb, vcodes)
    del vcodes

    # the one whole-volume stream of the szjx path: one launch each over
    # every symbol / chunk (``mono``)
    mrows = {}
    vflat = lorenzo_quant.lorenzo_quant(x, eb).reshape(1, -1)
    lane_kernel_rows(par, mrows, vflat, "szjx_stream", "one stream")
    del vflat

    lane_kernel_rows(par, rows, codes.reshape(codes.shape[0], -1), "main_512_lanes",
                     "all lanes in one launch")
    del codes

    dcodec, n_sym, dcs, chunk_bits, stream, _ = entropy.parse_chunked(art.tile_blobs[lane])
    cb = np.asarray(chunk_bits, np.int64)
    args, kw = dcodec._decode_inputs(stream, n_sym, dcs, np.cumsum(cb) - cb, dev)
    ids = huffman_decode.huffman_decode_probe(*args, **kw)
    par.compare("huffman_decode", "main_lane", ids, ref.huffman_decode_ref(*args, **kw))
    # bytes: the stream's words, the chunk offsets and counts read, the ids
    # written (the codec's tables are left out: they derive from its header)
    n_words = -(-int(cb.sum()) // 32)
    nbytes = 4 * (n_words + args[1].numel() + args[2].numel() + ids.numel())
    row("huffman_decode", lambda: huffman_decode.huffman_decode_probe(*args, **kw),
        lambda: ref.huffman_decode_ref(*args, **kw), nbytes, 16 * n_sym, plain_reps=5)
    rows["huffman_decode"]["shape_note"] = (f"{args[0].numel()} stream words, "
                                            f"ids [{ids.shape[0]}, {ids.shape[1]}]")
    del args, ids

    dcodec, n_sym, dcs, chunk_bits, stream, _ = entropy.parse_chunked(sz_art.code_blob)
    cb = np.asarray(chunk_bits, np.int64)
    args, kw = dcodec._decode_inputs(stream, n_sym, dcs, np.cumsum(cb) - cb, dev)
    ids = huffman_decode.huffman_decode_probe(*args, **kw)
    par.compare("huffman_decode", "szjx_stream", ids, ref.huffman_decode_ref(*args, **kw))
    n_words = -(-int(cb.sum()) // 32)
    nbytes = 4 * (n_words + args[1].numel() + args[2].numel() + ids.numel())
    time_row(mrows, "huffman_decode",
             lambda: huffman_decode.huffman_decode_probe(*args, **kw),
             lambda: ref.huffman_decode_ref(*args, **kw), nbytes, 16 * n_sym, reps=20,
             plain_reps=1)
    mrows["huffman_decode"]["shape_note"] = (f"{args[0].numel()} stream words, ids "
                                             f"[{ids.shape[0]}, {ids.shape[1]}], one stream")
    del args, ids

    gw_art, model, gw_launches = gw["gwlz"]
    rows.update(gwlz_kernel_rows(par, tile_slices(gw_art), model, "gwlz", "residual",
                                 with_g1=True))
    all_art, all_model, all_launches = gw["gwlz_all_groups"]
    all_rows = gwlz_kernel_rows(par, tile_slices(all_art), all_model, "gwlz_all_groups",
                                "pred", with_g1=False)
    mono_art, mono_model, mono_launches = mono
    from repro_torch.sz import SZCompressor

    mono_xs = SZCompressor("lorenzo").decompress(mono_art)  # 512 slices of 512x512
    mrows.update(gwlz_kernel_rows(par, mono_xs, mono_model, "gwlz_mono", "residual",
                                  with_g1=False))
    del mono_xs

    out = []
    for name, (source, replaces, _) in KERNELS.items():
        r = rows[name]
        if name in GWLZ_KERNELS:
            a = all_rows[name]
            r["all_groups"] = {"launches": all_launches[name], "shape": a.pop("shape_note"),
                               **a}
        if name in mrows:
            m = mrows[name]
            r["mono"] = {"launches": (mono_launches if name in GWLZ_KERNELS
                                      else path_launches["szjx"])[name],
                         "shape": m.pop("shape_note"), **m}
        path = LAUNCH_PATH[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": path_launches[path][name], "max_abs_err": par.err[name],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "ms_by": r["ms_by"], "call_ms": r["call_ms"], "shape": r["shape_note"],
                    "launches_path": path,
                    "launches_by_path": {p: ls[name] for p, ls in path_launches.items()},
                    **({"tolerance": par.tol[name]} if par.tol[name] else {}),
                    **{k: r[k] for k in ("flop", "g1", "all_groups", "mono", "parent", "stream")
                       if k in r}})
    return out


def cpu_vs_card(x_np) -> None:
    """The 128^3 corner compressed on the card and on the CPU: GWTC Lorenzo,
    GWTC interp and SZJX interp bytes must be identical."""
    import numpy as np

    from repro_torch.sz import SZCompressor

    corner = np.ascontiguousarray(x_np[:128, :128, :128])
    cases = {"gwtc_lorenzo": lambda sz, dev: sz.compress_tiled(
                 corner, TILE, rel_eb=REL_EB, predictor="lorenzo", device=dev),
             "gwtc_interp": lambda sz, dev: sz.compress_tiled(
                 corner, TILE, rel_eb=REL_EB, predictor="interp", device=dev),
             "szjx_interp": lambda sz, dev: sz.compress(corner, rel_eb=REL_EB, device=dev)}
    sz = SZCompressor(backend=BACKEND)
    out = {}
    for name, run in cases.items():
        t0 = time.perf_counter()
        card = run(sz, None)[0].to_bytes()
        t1 = time.perf_counter()
        cpu = run(sz, "cpu")[0].to_bytes()
        t2 = time.perf_counter()
        check(card == cpu, f"card and CPU {name} bytes differ on the 128^3 corner")
        out[name] = {"bytes": len(card), "bytes_identical": True, "card_s": t1 - t0,
                     "cpu_s": t2 - t1}
    emit({"phase": "cpu", "shape": [128, 128, 128], "cases": out})


def golden() -> None:
    import numpy as np

    from repro_torch.sz import TiledCompressed, decompress_tiled

    from repro_torch.sz import SZCompressed, decompress

    gold = ROOT / "tests" / "golden"
    for name, parse, decode in (("gwtc_v1", TiledCompressed.from_bytes, decompress_tiled),
                                ("szjx_lorenzo", SZCompressed.from_bytes, decompress)):
        got = decode(parse((gold / f"{name}.bin").read_bytes())).cpu().numpy()
        want = np.load(gold / f"{name}_decode.npy")
        check(got.shape == want.shape and np.array_equal(got.view(np.uint32),
                                                         want.view(np.uint32)),
              f"{name}.bin does not decode bit-exact")
    emit({"phase": "golden", "files": ["tests/golden/gwtc_v1.bin",
                                       "tests/golden/szjx_lorenzo.bin"], "bit_exact": True})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data import nyx_like_field
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    per_source = _build.build()
    ptxas = {name: [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                    if "Used" in ln] for name, log in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": per_source,
          "ptxas": ptxas, "torch": torch.__version__, "cuda": torch.version.cuda})

    par = Parity()
    edge_parity(par)

    t0 = time.perf_counter()
    x_np = nyx_like_field(SHAPE, "temperature", seed=0)
    emit({"phase": "field", "field": "temperature", "shape": list(SHAPE),
          "seconds": time.perf_counter() - t0})

    art, main_id, launches = main_path(x_np)
    legacy_launches, legacy_rows = legacy_path(par, x_np, art)
    gw = {"gwlz": gwlz_path(x_np, "gwlz")}
    t0 = time.perf_counter()
    vx = nyx_like_field(SHAPE, GWLZ_FIELDS["gwlz_all_groups"], seed=0)
    emit({"phase": "field", "field": GWLZ_FIELDS["gwlz_all_groups"], "shape": list(SHAPE),
          "seconds": time.perf_counter() - t0})
    gw["gwlz_all_groups"] = gwlz_path(vx, "gwlz_all_groups")
    del vx
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sz_art, sz_launches = szjx_path(x_np, Path(tmp))
        interp_launches = interp_path(x_np, Path(tmp))
        interp_tiled_launches, interp_id = interp_tiled_path(x_np)
        stream_launches = stream_path(x_np, Path(tmp), {"main": main_id,
                                                        "interp_tiled": interp_id})
        mono = gwlz_mono_path(x_np, Path(tmp))
        gw_interp = gwlz_mono_path(x_np, Path(tmp), "gwlz_interp", "interp")
        big_launches = bigstream_path(Path(tmp))
        serve_launches = serve_path(Path(tmp), art, gw["gwlz"][0], Path(tmp) / "field.szjx")
        gwds_launches = gwds_path(x_np, Path(tmp), art, main_id)
        ckpt_launches = checkpoint_path(x_np, Path(tmp))
        dist_launches = gwlz_dist_path(x_np, Path(tmp))
        lm_launches = lm_train_path(Path(tmp))
        lm_serve_path()
        lm_families_path(Path(tmp))
        dryrun_path(Path(tmp))
        cli_path(Path(tmp))
    path_launches = {"main": launches, "gwlz": gw["gwlz"][2], "szjx": sz_launches,
                     "interp": interp_launches, "interp_tiled": interp_tiled_launches,
                     "gwlz_mono": mono[2], "gwlz_interp": gw_interp[2],
                     "bigstream": big_launches, "stream": stream_launches,
                     "legacy": legacy_launches, "serve": serve_launches,
                     "gwds": gwds_launches, "checkpoint": ckpt_launches,
                     "gwlz_dist": dist_launches, "lm_train": lm_launches}
    # gwlz_dist runs no codec; lm_train's one compressed leaf is zlib-coded
    check(all(ls["huffman_decode"] > 0 for p, ls in path_launches.items()
              if p not in ("gwlz_dist", "lm_train")), "huffman_decode missed a path")
    check(all(ls["enhancer_fused"] > 0 for ls in (gw["gwlz"][2], gw["gwlz_all_groups"][2],
                                                 mono[2], gw_interp[2])),
          "enhancer_fused missed a path")
    del gw_interp
    with torch.no_grad():  # the model's parameters must not build autograd graphs here
        rows = kernel_rows(par, x_np, art, path_launches, gw, sz_art, mono, legacy_rows)
    cpu_vs_card(x_np)
    golden()

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
