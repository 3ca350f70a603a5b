#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (myzkp_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one output line each (or more), in order:
  1. device    the card (nvidia-smi name and power limit), torch, nvcc;
  2. build     the CUDA kernels from myzkp_tpu_torch/csrc/ with nvcc, one
               process per source, all started together, and the verifier's
               host pairing library (myzkp_tpu_torch/native/) with g++;
  3. bitcheck  each kernel against its plain PyTorch version on the card,
               exact equality of limbs (the tolerance is 0: modular integers):
               K1 over F_q on 2^20 random pairs after every pair of the
               word edges (values below q whose 32-bit words are each 0 or
               0xFFFFFFFF, and q - 1, 1, R mod q), every such pair also
               against the host; K2, K3 over F_q and the G1 group law; K4
               and its G2 instance
               (acc and the bucket table written in place: all four tags,
               flush targets with -1 and at step 0, rows of 0, 1, q - 1, R
               mod q in every coordinate component, 3000 lanes, K = 4; the
               point table read in order, the row-major contract the scan
               had before it read by index, and at random repeating
               indices); K14 gather_planes and K16 scatter_rows in both
               groups at a fixed-base chunk (8,388,608 int32 indices), the
               lane merge's 32,768 int64 repeating targets and its bucket
               table, 2^20 points and ragged sizes, with indices and
               without, then timed at those shapes beside the PyTorch calls
               they replaced; K7
               (with and without its select mask) and K8 over F_q2 at the
               MSM's 32,768 lanes (P+P, P+(-P), infinity on either side,
               z != 1, and lanes whose every c0 and c1 is 0, 1, q - 1 or R mod
               q) and K7 at a G2 fixed-base tree level; then K1 over F_r
               (the same edges), K1's chain mont_pow over F_q and F_r at 1,
               2, 3, 16 and 4,097 elements (0, 1, p - 1, R mod p among
               them) for e = 0, 1, 2, 3, p - 2 and a seeded 256-bit e,
               against mont_pow_ref and the host's pow(x, e, p); both forms
               of the chain at all three widths (mont_pow, mont_pow_l8,
               mont_pow_l4): n at the launcher's edge (the lane pair) and
               one past it (the window form), the word edges first, for
               e = 0, 1, 2, 3, alpha, alpha^-1, p - 2 and 2^256 - 1,
               against mont_pow_ref and the host; K1 with
               an operand broadcast as the paths broadcast it (the 1/n
               constant, coset offsets against (3, n), the four-step level
               table against E = 3, to_mont / from_mont columns), K5
               on 2^20 pairs (one stage, and log2 r stages: r =
               MYZKP_K5_RADIX) and at every pass of the m = 2^12 path's
               transforms and of fast_multiply's 2^9-point ones, each pass
               on the kernel's previous output, those of the first
               transform on a random table too (rows not starting with 1),
               K6 at every
               leaf shape of the 2^20 paths, at m = 16, 64, 128 with a
               ragged batch and at every stage count s = 1..7 of m = 128
               with a ragged batch, forward and inverse; segment_sum_mod on
               the card against the CPU and
               host ints, 2^20 entries with heavy duplicates; K2 and K7 (one
               G2 point on a lane pair) at 32,768 lanes, K2 at 2^17 + 5
               too, and at tail lengths that are not multiples of a block,
               a warp's 16 pairs or 2, with the mask on 1 lane in 32 and
               without, edge values, infinity, Q = P and Q = -P; the lane-merge
               levels of both groups (padd_seg_level, padd2_seg_level) at
               every level of the scan at the lane merge's (2, 16384) shape
               and at a ragged (3, 1000), under four head patterns (all,
               lane 0 only, 3 in 10 with lane 0 clear, 97 in 100), with edge
               values and infinity in the inputs, out and flags exact; and
               msm._seg_scan_hs on the card, exact, one launch a level; the
               chains of doublings K3 and K8 at 1 point, 16 points and a wide
               batch with a tail (2^16 + 3 for K3, 32,768 + 5 for K8), n = 1,
               16 and 255 with and without the steps output, exact against
               the plain version's 255 steps, with infinity, y = 0 (P = -P)
               and edge-value lanes, and 2^n P equal to the host's; K18
               (limb.add / sub: fe_add, fe_sub) at L = 16 (F_r, F_q), 8
               and 4 at every operand layout of addsub_layouts (the word
               edges, sums past R, a constant or a row on either side,
               narrow halves, stride-2 columns, a general broadcast and a
               transposed operand copied, an empty batch), exact against
               add_ref / sub_ref, each operand taken in place or copied as
               expected, then timed by graph replay at 2^24 (L = 16; also
               a fold's columns and Fp.sum's halves) and 2^20 (L = 8, 4)
               beside its bytes bound and the int64 chain it replaced;
  4. msm       the G1 slice: fixed-base setup of 2^20 points [m_i]G, then the
               2^20 Pippenger MSM against 2^20 scalars k_i, checked against
               the host's [sum k_i m_i mod r]G; kernel launch counts of that
               run; the MSM timed; msm_pippenger at n = 2^16 with c = 14,
               checked the same way; K2 timed beside its plain version;
               K3 and K8 timed at the prover's shapes (1 point,
               n = 16: a Horner window; 1 point, n = 255 with every step: a
               ladder's bases) and at their earlier shapes (16 points and
               32,768 lanes, n = 1), per double and beside their bounds;
               K4 at the MSM's shape (one window group's sorted digits, K = 64,
               32,768 lanes, reading the 2^20-point table by the path's own
               indices, checked below its rows; real flush targets checked
               unique) exact against its plain version, acc and bucket
               table, and timed beside it and beside the parent's path
               (index_select, then the scan of the copy read in order), and
               probe 13: the same 64 steps as 64 launches of K2 with the
               mask; the lane merge's first level on the scan's acc and the
               real segment heads, exact and timed with cold inputs, and with
               lane 0 the only head (every lane adds);
  5. ntt       a forward NTT of 2^20 seeded F_r elements checked at 3 points
               against host evaluation, intt(ntt(a)) == a, its launches, and
               its time;
  6. shifted h the prover's quotient stage get_shifted_h on square_chain(m)
               at m = 2^20 (four-step transforms over K6) and m = 2^12
               (Stockham stages over K5), each checked on the host: ell(w^j)
               equals the constraint evaluation u_j, and the Pinocchio
               identity (ell + d_ell t)(r + d_r t) - (o + d_o t) = H t holds at
               a random point; launch counts of each run; the calls timed;
               K5's launches at m = 2^12 exactly ceil(log2 n / log2 r) a
               transform; K5 timed at each pass of the batched 2^13-point
               coset NTT and over the whole transform (its passes in one
               graph, beside the transform's bound), K6
               timed beside its plain version, and K1 at the
               four-step level-twiddle pass over 3 x 2^21 elements (the
               quotient's shape) and at (16, 8192) (a setup to_mont), and
               its chain at 2 elements with e = q - 2 (the proof's
               inversion; also with CUDA events around the calls), and one
               product's latency on one warp (the lane pair on one element
               at 256 bits less at 17, over 239): the inversion's depth
               bound, and K17's at BN254 in phase 15;
  7. g2 msm    fixed-base setup of 2^20 G2 points [m_i]G2, then the 2^20 G2
               Pippenger MSM (one launch of K4's G2 instance per window
               group) against 2^20 scalars with a zero and duplicates,
               checked against the host's [sum k_i m_i mod r]G2; launch
               counts; the MSM timed; the G2 scan at the MSM's shape and
               probe 13 (64 launches of K7 with the mask), as for G1;
  8. pinocchio setup, prove and verify on square_chain(2^20): the proof is
               accepted and the proof of a wrong witness (one x_k changed) is
               rejected; launch counts of setup (its fixed-base row tables
               made anew, as in a fresh process) and of prove; setup seconds,
               prove median of 3, verify seconds (host); then setup and prove
               at m = 2^4 on the card and on the CPU plain versions with the
               same seeds, keys and proofs equal point for point; K3's and
               K8's prove launches on a line of their own, and K1's and its
               chain's (at most 100 together, the chain at least once); K7
               timed beside
               its plain version at the MSM's 32,768 lanes, and K2 at the
               same shape;
  9. mixed add the entry points weierstrass.padd_mixed / padd_mixed_sel, counted:
               K9 over G1 at 2^15 lanes (the mask set on about 1 lane in 32)
               and at 4,194,304 points, K10 (one point on a lane pair) over
               G2 at the MSM's 32,768 lanes; inputs with P = O, P = lam
               (qx, qy, 1) with lam != 1 (a doubling through the mixed
               formula), P = -Q (the sum is O), and
               lanes whose every c0 and c1 is 0, 1, q - 1 or R mod q; each
               kernel held against its plain version, against the complete add
               (K2, K7) of P and (qx, qy, one) and against the host group law
               on a sample of lanes, then timed beside its plain version; K10
               at 32,768 lanes (mask on 1 in 32) and at 2^20 lanes, and K7
               on the same inputs with Q = (qx, qy, one);
 10. groth16   setup, prove and verify on square_chain(2^20) with 2 public
               inputs: the proof is accepted, and rejected under a wrong public
               input; the proof of a wrong witness is rejected; launch counts
               of setup and of prove (K3's and K8's on a line of their own,
               and K1's and its chain's, as for Pinocchio);
               setup seconds, prove median of 3, verify seconds; then setup
               and prove at m = 2^4 on the card and on the
               CPU plain versions with the same seeds, keys and proofs equal
               point for point;
 11. kzg       KZG and Gemini (commit/kzg.py, commit/gemini.py) from a seeded
               toxic waste s: setup of degree 2^20 with every G2 power (the
               fixed-base tables; seconds, the host's powers of s timed
               alone), [s^i]G1 and [s^i]G2 equal to the host's at seeded i;
               a 2^20-coefficient commit equal to [p(s)]G1 (median of 3);
               open at a seeded u (y and w equal to the host's; verify
               accepts, and rejects y + 1; K1 and its chain launched fewer
               than 1,000 times); batch open at 3 points (ys and w equal to
               the host's; batch verify accepts, and rejects one y changed);
               the degree proof at d = 2^19 (equal to the host's; verify true
               at d, false at d - 1); Gemini over the 2^20 coefficients with
               20 seeded rhos and a seeded beta (each of the 21 commitments
               equal to the host's [f_i(s)]G1; verify accepts, and rejects
               mu + 1, two whole verifies timed apart); fast_multiply at
               2^19 x 2^19 (K6) and 2^8 x 2^8 (K5, ceil(9 / log2 r)
               launches a transform, three transforms)
               against the host's p(x) q(x) at 3 points; KZG and Gemini at
               degree 15 on the card and on the CPU plain versions with the
               same s, commitments and proofs equal point for point; launch
               counts of commit, open, batch open, the degree proof and
               Gemini's commit and open; times beside the card's name and
               power limit;
 12. sumcheck  both sumcheck provers (protocols/sumcheck_tpu.py,
               protocols/sumcheck.py): the table prover on the sumcheck
               demo's problem (three multilinear factors of 8 terms from
               seed 45, degree 3) over a 2^20-point hypercube: the verifier
               accepts, and rejects a changed claimed sum and a changed
               round coefficient; K1 launches a prove under 2,000; the
               prove timed (median of 3, split into table build and
               rounds); the same prover at 2^12 equal to the host mirror
               (claimed sum and every round polynomial); the Gemini-tied
               prove_sumcheck at el = 20 on phase 11's SRS, an 8-term
               multilinear g: the hypercube sum equal to the host's, c_g
               equal to [f_i(s)]G1 of the host folds at the transcript's
               challenges, verify_sumcheck accepting, and rejecting a
               changed h and a changed g_j; the prove split into host
               rounds, commit and open; each verify timed; launch counts.
 13. stark     the STARK over M128 (L = 8: the four-word kernels mont_mul_l8,
               mont_pow_l8, butterfly_l8, ntt_leaf_l8 and K17
               long_division_l8): K1 on 2^20 pairs after every pair of the
               four-word edges (32-bit words 0 or all ones, p - 1, 1, R mod
               p, and values in [2^127, p): M128 has no spare bit) against
               its plain version and the host, its chain at 1 to 4,097
               elements for e = 0, 1, 2, p - 2 and alpha^-1; Rescue-Prime
               (27 rounds) through Stark and FastStark on the card and on the
               CPU plain versions with the same seed, the proofs equal byte
               for byte, accepted, and a false output rejected on the card;
               hash_batch over 2^20 inputs (64 sampled outputs equal the host
               hash; timed; its 108 chain launches counted, in the window
               form); FastStark on the JAX package's squaring AIR at
               65,528 cycles over a 2^20-point FRI domain: preprocess, three
               proves from random.Random(7) (equal, each split by stage:
               trace interpolation, boundary quotients, codewords + Merkle,
               symbolic AIR, transition quotients, combination, FRI,
               openings), verify accepting, a false boundary's proof
               rejected, the first prove's launches (K5 gated at two a
               Stockham transform, 228 for the prove's 114, and held to
               its split's count); K5, K6 and K17 at every shape that prove
               launched them at against their plain versions (K5 also at
               K5_L8_EDGES: B = 3, rows off a tile, column counts and B_k
               that are no powers of two, 10 stages and 1, 9 and 10
               stages on 8 columns or more (tiles under 8 columns), the
               four-word edges leading each input and table, path and
               random tables; K6 also at ragged B, B not a multiple of 4,
               small m and its first stages only, forward,
               inverse and random tables; K17 past 512 steps a row
               against a = q b + r), then the five four-word kernels and
               K17's BN254 instance timed beside their plain versions and
               bounds (68 multiply-adds a 128-bit product; the chain's bound
               counts its window schedule's products); K6 and K17 timed at
               each shape of the prove and summed over its launches, and K5
               at each of the prove's Stockham transforms (k5_shapes: its
               count, launches a transform, graph-replay time of the whole
               transform, bound and the passes' tiles; summed);
 14. das       the extension fields and the data-availability models
               (fields/efield.py, codes/reedsolomon.py, das/): K1 and its
               chain at two words (M64: mont_mul_l4, mont_pow_l4) on 2^20
               pairs and elements after every pair of the two-word edges,
               exact against their plain versions and the edges against the
               host, then timed beside their bounds (18 multiply-adds a
               64-bit product); the M64 cubic extension at 2^20 elements:
               mul (two K1 launches and 8 of K18), inv (384 and 1,536:
               a x inv(a) = 1 where a != 0,
               inv(0) = 0) and pow_const, 64 of each equal to the host's
               Python ints and a slice equal to the CPU plain versions;
               BN254's Fq2 through the generic machinery at 2^20 equal to
               the Karatsuba Fq2Ops.mul; Celestia at a 128 x 128 square
               (256 x 256 extended: equal to the CPU parity-matrix encode, 4
               rows and 4 columns to the object-level coder; 512 roots and
               the data root; 16 samples verified, a tampered leaf
               rejected); Avail over a 2^20-byte blob (131,072 rows, KZG of
               degree 131,072 from a known s, 16 column commitments equal to
               the host's [p(s)]G1, 8 samples verified, a sample against
               another column's commitment rejected); EigenDA at 1,024
               bytes (8 chunks of 512, 5 samples verified, a changed y
               rejected); each stage timed, median of 3.
 15. dense     the dense R1CS / QAP (arith/r1cs.py, arith/qap.py) under
               Pinocchio and Groth16, the host GT pairing and the tutorials,
               and utils/ and the entry points: square_chain(2^12)
               densified into three (4096, 4098) matrices, the root-of-unity
               QAP: Pinocchio and Groth16 (1 public input) keys equal to the
               sparse QAP's batch for batch and proofs point for point under
               the same seeds, accepted, a wrong witness rejected, the proves'
               launch counts, medians of 3 and peak memory; square_chain(2^9)
               on the natural domain: Pinocchio accepted, a wrong witness
               rejected, K17 launched in the prove at (1, 1023, 512) and that
               call exact against long_division_ref, h(s) t(s) = ell(s) r(s) -
               o(s) on the host; both domains at m = 2^4 on the card and on
               the CPU plain versions, keys and proofs equal; the C++ pairing
               equal to optimal_ate_pairing_ref and bilinear; both tutorial
               ladders as tests/test_tutorial_protocols.py expects; the 2^12
               keys saved and reloaded prove the same proof; msm_resumable
               over 2^20 points in chunks of 2^18 stopped after 2 and resumed
               equal to msm, its file removed; a prove under torch.profiler
               shows the port's spans; python -m myzkp_tpu_torch.snark.cli 12 and
               python -m myzkp_tpu_torch.protocols.sumcheck_cli (8 variables)
               exit 0, and snark.cli 12 --mesh 2 (two ranks sharing the
               card), snark.cli --g2 naive is refused; K17 at (1, 1023, 512)
               timed beside its plain version, its operations bound and its
               depth bound (511 quotient coefficients one after another, one
               product's latency each);
 16. mesh      parallel/mesh.py: 4 ranks spawned by run_ranks, over NCCL on
               a host of four cards, else sharing the card (gloo, each
               collective staged through pinned host memory); each runs
               square_chain(2^20)'s Pinocchio setup and Groth16's split-key
               setup (its block of the key; one seed each, a group's key
               freed before the next), the mesh proves (launch counts and
               collective bytes set to 0 just before and read just after;
               seconds and peak memory per rank), verifies them, and rank 0
               holds every rank's proof equal point for point to its
               single-rank prove of the same toxic waste and seed (Groth16's
               with the whole key);
               then dist_ntt at 2^20 == ntt, dist_msm over 2^20 G1 points ==
               msm and at c = 14 over 2^16, dist_fold_into_half and
               dist_table_sum over a 2^20 F_r table, dist_fri_fold (two
               rounds) and dist_merkle_tree (root and paths) over a
               2^20-point M128 codeword == fold_codeword and MerkleTree; and
               the mesh Pinocchio prove once at D = 1 on NCCL.  Four ranks on
               one card give no scaling figure.  Rank 0's kernel calls in
               each mesh prove (Groth16's block quotient's included) are
               held to their plain versions.
 17. surface   the last of the JAX package's surface, driven once with the
               launch counts set to 0 just before and read just after: K5's
               pair form (ntt_kernels.butterfly_pair, the TPU kernel's own
               DIF / DIT contract) at L = 16, 8 and 4 on 2^20 pairs, every
               pair of the word edges and 0 first, exact against its plain
               version on the card in both modes, the edges and a sample
               against the host, each timed by graph replay beside its plain
               version and its bytes bound; msm_pippenger on unsigned digits
               over 2^20 G1 points at c = 16 equal to the signed MSM and the
               host golden, every kernel call of it held to its plain version
               at its own shapes (kernel_calls, as phase 16), both timed
               (median of 3); unsigned at c = 14 over 2^16 G1 (also with a
               caller's G = 3) and G2 points and c = 1 over 5 points against
               the host; scalar_mul_const over 2^15 G1 points with a 254-bit
               e and pow_dyn over 2^20 F_r elements with 256-bit exponents,
               samples against the host; the GT helpers (gt_mul_coeffs,
               gt_pow_coeffs, gt_inv_coeffs) against bilinearity.
The build phase prints ptxas's registers and spills of every kernel and the
static SASS instruction counts (cuobjdump -sass) of the curve kernels.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is a JSON object with one entry per kernel (its
"launches" from the proves (for the four-word kernels and K17, phase
13's first FastStark prove), "kzg_launches" from phase 11's runs,
"sumcheck_launches" from phase 12's, "stark_launches" from phase 13's prove,
"das_launches" from phase 14's runs, "dense_launches" from phase 15's three
dense proves, "mesh_launches" and "mesh_g16_launches" from rank 0's mesh
Pinocchio and Groth16 proves in phase 16, "surface_launches" from phase 17's
driven run; for the two-word kernels "launches" are phase 14's efield runs,
for K17's BN254 instance phase 15's natural-domain prove; K5's pair form is
on no path, its "launches" read from phase 8's Pinocchio prove like the
other BN254 kernels', K18's at L = 16 among them); the last line is
{"ok": true, "device": {...}}.
Any failure exits nonzero before it.
Neither this script nor the port imports JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 42
LOG_N = 20
LOG_N_C14 = 16
LOG_M_BIG, LOG_M_SMALL = 20, 12  # shifted h: four-step (K6) and Stockham (K5)
LOG_M_PIN = 20  # Pinocchio setup / prove / verify on square_chain(2^20)
LOG_M_CMP = 4  # the whole path on the card and on the CPU plain versions
LOG_M_G16, NPUB_G16 = 20, 2  # Groth16 on square_chain(2^20), 2 public inputs
MIX_WIDE = 1 << 22  # K9 at a fixed-base tree level's width (K2's timed shape)

# The card's peaks for a kernel's bound (NVIDIA H100 SXM at 700 W): device
# memory 3.35 TB/s; 32-bit integer multiply-adds at 64 per SM per clock
# (half the 128 float32 lanes behind the 67 TFLOP/s float32 peak), 132 SMs,
# 1.98 GHz.  A 256-bit Montgomery product (CIOS over eight 32-bit words) is
# 264 of them: 64 wide products a*b and 64 m*p at two each, plus 8 for m; a
# 128-bit one (M128, four words) 68: 16 and 16 at two each, plus 4; a 64-bit
# one (M64, two words) 18: 4 and 4 at two each, plus 2.  K17 sums its
# products unreduced (csrc/poly.cu's WideSum): a product is the 2 N^2
# multiply-adds of a b at N words, and one reduction of (N + 1) 2N serves a
# sum of up to B = 64 of them: 32 + 40 / 64 at M128, 128 + 144 / 64 at BN254.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
IMAD_PER_MONT = 264
IMAD_PER_MONT4 = 68
IMAD_PER_MONT2 = 18
IMAD_PER_DIV = 2 * 8 * 8 + 2 * 8 * 9 / 64
IMAD_PER_DIV4 = 2 * 4 * 4 + 2 * 4 * 5 / 64
LIMB_BYTES = 64  # one element at the tensor interface: 16 int32 limbs
LIMB_BYTES4 = 32  # an M128 element: 8 int32 limbs
LIMB_BYTES2 = 16  # an M64 element: 4 int32 limbs
VALUE_BYTES2 = 8  # the 64-bit value those limbs hold
MSM_KERNELS = ("mont_mul", "mont_pow", "padd", "pdbl", "bucket_scan_rows", "padd_seg_level",
               "gather_planes", "scatter_rows")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of fn over reps calls (after one warm-up), CUDA events
    around the calls: the device's time where it is the longer, else the
    host's time to make the calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Mean device time of fn's launches: reps calls captured in one CUDA
    graph (after one warm-up call), the graph replayed once to warm up and
    then timed with CUDA events.  The host's cost of a call is left out, so
    a launch shorter than the host takes to make it reads its own time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def bound(nbytes: float, mont_products: float, imad: float = IMAD_PER_MONT) -> dict:
    """The least time the card could take: bytes at the memory rate against
    Montgomery products (``imad`` multiply-adds each) at the integer
    multiply rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mont_products * imad / IMAD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed(fn):
    """(fn(), its seconds on the host clock, ended by a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = card()
    from myzkp_tpu_torch import _ext

    nvcc = subprocess.run([_ext._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"# device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc {nvcc}")


def phase_build() -> dict:
    """Build the kernels and the host pairing; print registers, spills and
    SASS counts, and return the SASS counts by kernel."""
    from myzkp_tpu_torch import _ext, native

    seconds = _ext.build()
    _ext.library()
    log(f"# build: {len(list(_ext.CSRC.glob('*.cu')))} sources -> "
        f"{_ext.library_path().name} in {seconds:.2f} s")
    t0 = time.perf_counter()
    native.build()
    native.library()
    log(f"# build: the verifier's host pairing -> {native.library_path().name} "
        f"in {time.perf_counter() - t0:.2f} s (g++)")
    for line in _ext.library_path().with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            log(f"#   ptxas: {line.strip()}")
    sass = sass_counts(_ext.library_path())
    for kernel, counts in sass.items():
        log(f"#   sass {kernel}: {json.dumps(counts)}")
    return sass


# SASS opcode classes counted per kernel: the 32-bit multiply-adds and adds of
# the Montgomery products and the carry chains, local memory (spills),
# shuffles, global memory, branches and calls.
SASS_CLASSES = ("IMAD", "IADD3", "LOP3", "SEL", "ISETP", "LDL", "STL", "SHFL", "LDG",
                "STG", "BRA", "CALL")


def sass_counts(lib) -> dict:
    """Static instruction counts of each curve kernel in the built library,
    from cuobjdump -sass: the total and each class of SASS_CLASSES (an opcode
    counts in the class it starts with: IMAD.WIDE.U32 is an IMAD)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = next((k for k in SASS_KERNELS if k in m.group(1)), None)
            arg = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", m.group(1))
            if name and arg:  # a template instantiation: kernel<R>, kernel<R,T> or kernel<N,flag>
                name = f"{name}<{','.join(g for g in arg.groups() if g is not None)}>"
            if name:
                out[name] = dict.fromkeys(("total",) + SASS_CLASSES, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            out[name]["total"] += 1
            cls = next((c for c in SASS_CLASSES if op.startswith(c)), None)
            if cls:
                out[name][cls] += 1
    return out


SASS_KERNELS = ("padd_seg_level_kernel", "padd2_seg_level_kernel", "padd_mixed_kernel",
                "padd_mixed2_kernel", "padd2_kernel", "pdbl2_kernel", "padd_kernel",
                "pdbl_kernel", "mont_mul_kernel", "mont_pow_kernel", "ntt_leaf_kernel",
                "butterfly_kernel", "mont_mul_l8_kernel", "mont_pow_l8_kernel",
                "ntt_leaf_l8_kernel", "stockham_l8_kernel", "div_rows_kernel",
                "div_chunks_kernel", "div_block_kernel", "mont_mul_l4_kernel",
                "mont_pow_l4_kernel", "mont_pow_wide_kernel", "mont_pow_wide_l8_kernel",
                "mont_pow_wide_l4_kernel", "fe_addsub_kernel")


def random_fe(rng: np.random.Generator, n: int, dev) -> torch.Tensor:
    """n random canonical F_q limb columns (top limb kept below q's)."""
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] = rng.integers(0, 0x3064, size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def word_edges(p: int, words: int = 8) -> list:
    """The values below p whose 32-bit words (eight, four for M128, two for
    M64) are each 0 or 0xFFFFFFFF, then p - 1, 1 and R mod p: the operands at
    the ends of every carry chain of the Montgomery product.  Where p has no
    spare bit (M128, M64: p > R / 2) also values in [R / 2, p), whose sums
    and products pass R: with w words, 2^(32w - 1), 2^(32w - 1) + 1,
    2^(32w - 1) + 2^(32(w - 1)) - 1 and p - 2."""
    out = []
    for bits in range(1 << words):
        v = sum(0xFFFFFFFF << (32 * k) for k in range(words) if bits >> k & 1)
        if v < p:
            out.append(v)
    half = 1 << (32 * words - 1)
    top = [half, half + 1, half + (1 << (32 * (words - 1))) - 1, p - 2] if p > half else []
    return out + [p - 1, 1, (1 << (32 * words)) % p] + top


def bitcheck_mont_mul(spec, rng, dev, name: str) -> int:
    """K1 on 2^20 pairs: every pair of word_edges first, then random; exact
    against the plain version, and the edge pairs against the host too.
    Returns the max_abs_err."""
    from myzkp_tpu_torch.fields import limb

    p = spec.p
    edges = word_edges(p)
    k = len(edges) ** 2
    n = 1 << LOG_N
    a, b = random_fe(rng, n, dev), random_fe(rng, n, dev)
    a[:, :k] = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    b[:, :k] = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    got = limb.mont_mul(spec, a, b)
    err = check_equal(name, [got], [limb.mont_mul_ref(spec, a, b)])
    rinv = pow(1 << 256, -1, p)
    gi = limb.to_int(spec, got[:, :k])
    if any(int(g) != x * y * rinv % p
           for g, (x, y) in zip(gi, ((x, y) for x in edges for y in edges))):
        raise AssertionError(f"{name}: disagrees with the host on the word edges")
    log(f"# bitcheck {name}: 2^{LOG_N} pairs, the first {k} every pair of {len(edges)} "
        f"word edges (each 32-bit word 0 or 0xFFFFFFFF below p; p - 1, 1, R mod p): "
        f"exact, and the edge pairs == host")
    return err


def check_equal(name: str, got, want) -> int:
    got, want = list(got), list(want)
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain version disagree")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_bitcheck(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, msm
    from myzkp_tpu_torch.fields import limb

    rng = np.random.default_rng(SEED)
    spec = bn254.q_spec()

    # K1 at 2^20 pairs, the word edges first
    err = bitcheck_mont_mul(spec, rng, dev, "mont_mul")
    results["mont_mul"] = {"max_abs_err": err}

    # K2 / K3 at 2^16 points: projective rescalings of 63 host points and
    # infinity, with P+P, P+(-P), P+O, O+Q and O+O among them
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
    g = bn254.g1_generator()
    hrng = random.Random(SEED)
    host = [g * hrng.randrange(1, bn254.R) for _ in range(63)]
    host.append(bn254.curve_g1.infinity())
    base = bn254.g1_points_to_device(host, dev)
    m = 1 << 16
    ia = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    ib = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    kinds = torch.from_numpy(rng.integers(0, 8, m)).to(dev)
    ib = torch.where(kinds == 0, ia, ib)  # P + P
    ib = torch.where(kinds == 1, torch.full_like(ib, 63), ib)  # P + O
    ia = torch.where(kinds == 2, torch.full_like(ia, 63), ia)  # O + Q
    ia = torch.where(kinds == 3, torch.full_like(ia, 63), ia)  # O + O
    ib = torch.where(kinds == 3, torch.full_like(ib, 63), ib)

    def rescaled(idx):
        lam = random_fe(rng, m, dev)
        lam[0] |= 1  # nonzero
        return tuple(limb.mont_mul_ref(spec, c[:, idx], lam) for c in base)

    P, Q = rescaled(ia), rescaled(ib)
    negate = kinds == 4  # P + (-P)
    Q = (torch.where(negate, P[0], Q[0]),
         torch.where(negate, limb.neg(spec, P[1]), Q[1]),
         torch.where(negate, P[2], Q[2]))
    h = torch.from_numpy(rng.integers(0, 2, m).astype(bool)).to(dev)
    err = check_equal("padd", ck.padd(spec, b3, P, Q), ck.padd_ref(spec, b3, P, Q))
    err = max(err, check_equal("padd(h)", ck.padd(spec, b3, P, Q, h),
                               ck.padd_ref(spec, b3, P, Q, h)))
    sums = ck.padd(spec, b3, P, Q)
    got = bn254.g1_points_to_host(tuple(c[:, :256] for c in sums))
    ha, hb = ia[:256].tolist(), ib[:256].tolist()
    kk = kinds[:256].tolist()
    want = [host[x] + (-host[x] if k == 4 else host[y])
            for x, y, k in zip(ha, hb, kk)]
    if got != want:
        raise AssertionError("padd: disagrees with the host group law")
    results["padd"] = {"max_abs_err": err}
    log(f"# bitcheck padd: 2^16 points (P+P, P+(-P), P+O, O+Q, O+O), "
        f"with and without h: exact; 256 sums match the host")
    err = check_equal("pdbl", ck.pdbl(spec, b3, P), ck.pdbl_ref(spec, b3, P))
    dbl = bn254.g1_points_to_host(tuple(c[:, :256] for c in ck.pdbl(spec, b3, P)))
    if dbl != [host[x] + host[x] for x in ha]:
        raise AssertionError("pdbl: disagrees with the host group law")
    results["pdbl"] = {"max_abs_err": err}
    log("# bitcheck pdbl: 2^16 points incl. O: exact; 256 match the host")

    # K4 at N = 3000 lanes (ragged), K = 4
    rows, _ = msm._rows_of_point(tuple(c[:, :4 * 3000] for c in P))
    err = bitcheck_scan(spec, F, b3, rows, 4, rng, dev)
    results["bucket_scan_rows"] = {"max_abs_err": err}
    log(f"# bitcheck bucket_scan_rows: {SCAN_CASE}: acc and bucket table exact")


SCAN_CASE = ("N = 3000 lanes, K = 4, tags 0-3, flush targets on 3 steps in 10 "
             "(step 0 included) and -1 elsewhere, 375 table rows of 0, 1, q - 1, R mod q "
             "in every coordinate component; the table read in order (the row-major "
             "contract it replaced) and at seeded random indices with repeats")


def scan_table(F, S: int, width: int, dev):
    """An S-row bucket table of infinity rows, as the MSM makes it."""
    from myzkp_tpu_torch.curves import msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    return msm._rows_of_point(wst.infinity(F, (S,), dev), width)[0]


def bitcheck_scan(spec, F, b3, table, K: int, rng, dev) -> int:
    """K4 (G1) or its G2 instance against the plain version on a table of
    K * N points: all four tags (the first eight pinned), unique random flush
    targets on about 3 steps in 10, step 0 included, -1 elsewhere; N / 8
    rows at seeded random positions hold 0, 1, q - 1 or R mod q in every
    coordinate component.  Read in order (idx = arange: step k of lane l
    reads row k * N + l, the row-major contract the scan had before it read
    by index), some edge rows are added (no segment head) to a live
    accumulator at a step after 0; then read at seeded random indices with
    repeats.  acc and the whole bucket table must agree exactly."""
    from myzkp_tpu_torch.curves import curve_kernels as ck
    from myzkp_tpu_torch.fields import limb

    total, W = table.shape
    N = total // K
    table = table.clone()
    E = N // 8
    at = np.sort(rng.choice(total, E, replace=False))
    at_dev = torch.from_numpy(at).to(dev)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    for j in range(W // 64 * 3):  # coordinate components: 3 for G1, 6 for G2
        vals = [edges[i] for i in rng.integers(0, 4, E)]
        table[at_dev, 16 * j:16 * j + 16] = limb.from_int(spec, vals, dev).T
    tag = torch.from_numpy(rng.integers(0, 4, total).astype(np.int32)).to(dev)
    tag[:8] = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0], dtype=torch.int32)
    if not ((at >= N) & (tag.cpu().numpy()[at] & 2 == 0)).any():
        raise AssertionError("bucket scan bitcheck: no edge row added after step 0")
    S = total + 64
    tgt = np.where(rng.random(total) < 0.3, rng.permutation(S)[:total], -1)
    tgt = torch.from_numpy(tgt.astype(np.int32)).to(dev)
    if not (tgt[:N] >= 0).any():
        raise AssertionError("bucket scan bitcheck: no flush at step 0")
    g2 = isinstance(b3, tuple)
    name = "bucket_scan_rows2" if g2 else "bucket_scan_rows"
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    at_random = torch.from_numpy(rng.integers(0, total, total).astype(np.int32)).to(dev)
    if at_random.unique().numel() == total:
        raise AssertionError("bucket scan bitcheck: no repeated index")
    err = 0
    for kind, idx in (("in order", torch.arange(total, dtype=torch.int32, device=dev)),
                      ("random, repeating", at_random)):
        t_k, t_p = scan_table(F, S, W, dev), scan_table(F, S, W, dev)
        acc = scan(spec, table, idx, tag, tgt, b3, t_k, K)
        acc_p = ck.bucket_scan_rows_ref(spec, table, idx, tag, tgt, b3, t_p, K)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"{name} [idx {kind}]", [acc, t_k], [acc_p, t_p]))
    return err


def time_scan(F, b3, pts, dev, results: dict) -> None:
    """The bucket scan at the 2^20 MSM's shape, one window group (c = 16,
    G = 2, K = 64, 32,768 lanes) of seeded scalars' sorted digits, reading
    the 2^20-point table by the path's own indices, with its tags and
    targets: the indices checked below the table's rows, the real targets
    unique, the kernel held to its plain version (acc and the whole bucket
    table exact; repeated launches rewrite the same rows), both timed, and
    beside them the parent's path: the step-major gather (index_select) and
    the scan over the gathered copy read in order, held to the kernel's
    result and timed, each of the two also alone.  It is two steps, not one
    PyTorch call computing the scan, so library_ms stays null.  Then probe 13
    (tools/exp_kernel_ledger.py:80): the same K steps as K launches of the
    select-masked complete add (K2 for G1, K7 for G2) over plane-major
    inputs laid out beforehand from its own gathered copy, its result equal
    to the scan's acc, timed the same way."""
    from myzkp_tpu_torch.curves import curve_kernels as ck, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    g2 = isinstance(b3, tuple)
    name = "bucket_scan_rows2" if g2 else "bucket_scan_rows"
    spec = F.spec
    n = wst.leaves(pts)[0].shape[1]
    rng = np.random.default_rng(SEED + 10)
    c = msm.default_window(n)
    num_buckets = (1 << (c - 1)) + 1
    G = msm._group_size(n, -(-256 // c), num_buckets + 1)
    K = int(min(n, max(8, msm._next_pow2(G * n // (1 << 15)))))
    N = G * n // K
    digits, dneg = msm.signed_digits(msm.scalar_digits(random_fe(rng, n, dev), c), c)
    d_sorted, order = torch.sort(digits[:G], dim=1, stable=True)
    vals = (torch.arange(n, dtype=torch.int32, device=dev)[None] << 1) | dneg[:G].int()
    idx, tag, tgt = msm._scan_inputs(vals.gather(1, order), d_sorted, num_buckets, K)
    table, C = msm._rows_of_point(pts)
    if int(idx.min()) < 0 or int(idx.max()) >= table.shape[0]:
        raise AssertionError(f"{name}: an index outside the {table.shape[0]}-row table")
    real = tgt[tgt >= 0]
    msm._check_unique_targets(real, num_buckets, num_buckets + 1)  # raises
    if (tgt[:N] >= 0).any():
        raise AssertionError(f"{name}: a flush target at step 0")
    S, W = G * (num_buckets + 1), table.shape[1]
    scan = ck.bucket_scan_rows2 if g2 else ck.bucket_scan_rows
    t_k, t_p, t_l = (scan_table(F, S, W, dev) for _ in range(3))
    in_order = torch.arange(K * N, dtype=torch.int32, device=dev)
    kern = lambda: [scan(spec, table, idx, tag, tgt, b3, t_k, K), t_k]
    plain = lambda: [ck.bucket_scan_rows_ref(spec, table, idx, tag, tgt, b3, t_p, K), t_p]
    parent = lambda: [scan(spec, table.index_select(0, idx), in_order, tag, tgt, b3, t_l, K),
                      t_l]
    heads, flushes = int(((tag & 2) > 0).sum()), int(real.numel())
    adds = 42 if g2 else 14  # Montgomery products of a complete add
    # the used limbs of each table row the steps read, once; each step's
    # index, tag and target; the real flushes; acc
    used = int(idx.unique().numel())
    bnd = bound(used * 4 * C + K * N * 12 + flushes * 4 * C + N * 4 * C
                + LIMB_BYTES * (C // 48), adds * (K * N - heads))
    shape = f"K = {K}, N = {N} lanes, {heads} heads, {flushes} real flushes"
    time_cases({name: (shape, kern, plain, 5, 1, bnd)}, results)
    acc = kern()[0]
    check_equal(f"{name} the parent's path [{shape}]", parent(), kern())
    rows = table.index_select(0, idx)  # the parent's gathered copy
    split = {"parent_path_ms": graph_time_ms(parent, 5),
             "index_select_ms": graph_time_ms(lambda: table.index_select(0, idx), 5),
             "scan_of_copy_ms": graph_time_ms(
                 lambda: scan(spec, rows, in_order, tag, tgt, b3, t_l, K), 5)}
    results.setdefault("_scan_parent_path", {})[name] = split
    log(f"# {name}: the parent's path {split['parent_path_ms']:.4f} ms = index_select "
        f"{split['index_select_ms']:.4f} ms + the scan of the copy read in order "
        f"{split['scan_of_copy_ms']:.4f} ms; the scan reading the table by index "
        f"{results[name]['ms']:.4f} ms")

    # probe 13: K launches of K2 / K7 with the mask, acc <- Q on a head
    q_rows = rows.reshape(K, N, W)
    steps = []
    for k in range(K):
        q = msm._point_of_rows(q_rows[k], C, (N,))
        neg = (tag[k * N:(k + 1) * N] & 1) > 0
        q = wst.point_map(torch.Tensor.contiguous,
                          wst.Point(q.x, F.select(neg, F.neg(q.y), q.y), q.z))
        steps.append((q, (tag[k * N:(k + 1) * N] & 2) > 0))
    add = ck.padd2 if g2 else ck.padd

    def loop():
        p = wst.point_map(torch.Tensor.contiguous, wst.infinity(F, (N,), dev))
        for q, h in steps:
            p = add(spec, b3, p, q, h)
        return p

    check_equal(f"probe 13 [{name}]", list(wst.leaves(loop())),
                list(wst.leaves(wst.from_leaves(acc.split(16)))))
    time_level(F, b3, acc, d_sorted, K, results)
    loop_ms = cuda_time_ms(loop, 3)
    results.setdefault("_probe13", {})[name] = {
        "scan_ms": results[name]["ms"], "loop_ms": loop_ms, "K": K, "lanes": N,
        "heads": heads, "real_flushes": flushes}
    log(f"# probe 13 [{shape}]: {K} launches of {'K7' if g2 else 'K2'} with the "
        f"mask {loop_ms:.4f} ms against the scan's {results[name]['ms']:.4f} ms; "
        f"the loop's acc == the scan's")


def time_level(F, b3, acc, d_sorted, K: int, results: dict) -> None:
    """The lane merge's first level (d = 1) on its own inputs in the 2^20
    MSM: the scan's acc as (G, B) lanes and the segment heads of the lanes'
    last digits, as msm._merge_lane_partials makes them; held to its plain
    version and timed.  Then the same lanes with lane 0 the only head, where
    every other lane adds (the level's most work at this shape)."""
    from myzkp_tpu_torch.curves import curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    g2 = isinstance(b3, tuple)
    name = "padd2_seg_level" if g2 else "padd_seg_level"
    level = ck.padd2_seg_level if g2 else ck.padd_seg_level
    ref = ck.padd2_seg_level_ref if g2 else ck.padd_seg_level_ref
    spec = F.spec
    G, n = d_sorted.shape
    B = n // K
    x = tuple(wst.point_map(lambda a: a.reshape(16, G, B).contiguous(),
                            wst.from_leaves(acc.split(16))))
    d_end = d_sorted.reshape(G, B, K)[..., -1]
    ones = torch.ones((G, 1), dtype=torch.bool, device=d_end.device)
    heads = torch.cat([ones, d_end[:, 1:] != d_end[:, :-1]], dim=-1)
    C = 48 * (2 if g2 else 1)
    adds_per = G2_ADD_PRODUCTS if g2 else 14
    L = lambda r: list(wst.leaves(wst.Point(*r[0]))) + [r[1]]
    nbytes = 2 * (4 * C * G * B + G * B) + LIMB_BYTES * (C // 48)
    copies = [x] + [tuple(wst.point_map(torch.clone, wst.Point(*x)))
                    for _ in range(2 * L2_BYTES // nbytes + 1)]
    for kind, h in (("path", heads), ("lane0", torch.zeros_like(heads))):
        h = h.clone()
        h[:, 0] = True
        adds = int((~h).sum())
        kern, kept = cold_calls(lambda xc: L(level(spec, b3, xc, h, 1)), copies)
        case = {name: (f"({G}, {B}) lanes, d = 1, heads {kind}: {adds} adds; "
                       f"inputs cold ({len(copies)} copies)",
                       kern, lambda: L(ref(spec, b3, x, h, 1)), 50, 1,
                       bound(nbytes, adds_per * adds))}
        if kind == "path":
            time_cases(case, results)
        else:
            res = {name: {"max_abs_err": 0}}
            time_cases(case, res)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               res[name]["max_abs_err"])
            results.setdefault("_levels_all_adds", {})[name] = res[name]
        kept.clear()


def cold_calls(fn, inputs: list):
    """(call, kept): call() runs fn on inputs[0], inputs[1], ... in turn and
    keeps every result in kept.  With enough copies of the same inputs that
    the bytes between two uses of one copy pass the L2, each call reads its
    inputs from memory and writes memory that no call has touched, as the
    bytes bound assumes; a graph replay of one input set would find it in
    L2.  Clear kept after the timing."""
    turn, kept = itertools.cycle(inputs), []

    def call():
        kept.append(fn(next(turn)))
        return kept[-1]
    return call, kept


def phase_slice(dev, results: dict) -> None:
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    n = 1 << LOG_N
    rng = random.Random(SEED)
    ms = [rng.randrange(1, bn254.R) for _ in range(n)]
    ks = [rng.randrange(0, bn254.R) for _ in range(n)]
    ks[0], ks[1], ks[2], ks[3] = 0, 5, 5, bn254.R - 1  # zero and duplicates
    rspec = bn254.r_spec()
    m_limbs = msm.scalars_from_int(rspec, ms, dev)
    k_limbs = msm.scalars_from_int(rspec, ks, dev)
    F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
    g = bn254.g1_generator()
    exp = g * (sum(k * m for k, m in zip(ks, ms)) % bn254.R)

    def to_host_single(pt):
        return bn254.g1_points_to_host(wst.Point(*(c[:, None] for c in pt)))[0]

    # the main path, counted: setup, MSM, result to the host
    table = ("loaded from its .npz cache"
             if fixed_base.table_path("g1").exists()
             else "built on the host first")
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    pts = fixed_base.fixed_base_multi("g1", m_limbs)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = msm.msm(F, b3, pts, k_limbs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = to_host_single(res)
    counts = {k: _ext.launches[k] for k in MSM_KERNELS}
    if got != exp:
        raise AssertionError("MSM 2^20: result differs from the host golden")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    c = msm.default_window(n)
    log(f"# slice fixed-base g1 2^{LOG_N}: {fb_s:.3f} s (table {table})")
    log(f"# slice msm 2^{LOG_N} (c = {c}): first run {first_s:.3f} s; result "
        f"== host [sum k_i m_i mod r]G")
    log(f"# slice launches: {json.dumps(counts)}")
    for k, v in counts.items():
        results[k]["launches"] = v

    # MSM timing: median of 5 reps after the warm-up above
    med, ts = median_ms(lambda: msm.msm(F, b3, pts, k_limbs))
    results["_msm"] = {"ms": med, "reps_ms": ts, "points_per_s": n / med * 1e3,
                       "fixed_base_s": fb_s}
    log(f"# slice msm 2^{LOG_N}: median {med:.2f} ms of "
        f"{[round(t, 2) for t in ts]} -> {n / med * 1e3:,.0f} points/s")

    # msm_pippenger at 2^16 with c = 14 (the step-0 flush fault's shape)
    n2 = 1 << LOG_N_C14
    sub = wst.Point(*(c_[:, :n2] for c_ in pts))
    res2 = msm.msm_pippenger(F, b3, sub, k_limbs[:, :n2].contiguous(), c=14)
    exp2 = g * (sum(k * m for k, m in zip(ks[:n2], ms[:n2])) % bn254.R)
    if to_host_single(res2) != exp2:
        raise AssertionError("MSM 2^16 c = 14: result differs from the host")
    log(f"# slice msm_pippenger 2^{LOG_N_C14} c = 14: == host golden")

    # each kernel beside its plain version at the slice's own shapes
    spec = bn254.q_spec()
    W = -(-256 // 8)
    tree_w = (W // 2) * fixed_base._CHUNK  # first tree level of one chunk
    x = tuple(cc.repeat(1, -(-tree_w // n))[:, :tree_w].contiguous() for cc in pts)
    y = tuple(torch.roll(cc, 1, dims=1) for cc in x)
    cases = {
        "padd": (f"{tree_w} points, first fixed-base tree level",
                 lambda: ck.padd(spec, b3, x, y),
                 lambda: ck.padd_ref(spec, b3, x, y), 5, 1,
                 bound(9 * LIMB_BYTES * tree_w + LIMB_BYTES, 14 * tree_w)),
    }
    time_cases(cases, results)
    del x, y
    time_scan(F, b3, pts, dev, results)


def time_cases(cases: dict, results: dict) -> None:
    """Each kernel against its plain version (exact), then both timed: the
    kernel by graph replay (graph_time_ms), the plain version with CUDA
    events around its calls; the bound and the library time go beside
    them.  A case is (shape, kernel, plain, reps, plain reps, bound) and,
    where PyTorch calls compute the same function, a seventh entry: those
    calls, held to the kernel's result and timed by graph replay as
    library_ms (else null: no PyTorch call computes a 256-bit Montgomery
    product)."""
    as_list = lambda r: [r] if torch.is_tensor(r) else list(r)
    for name, (shape, kern, plain, reps, preps, bnd, *lib) in cases.items():
        err = check_equal(f"{name} [{shape}]", as_list(kern()), as_list(plain()))
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms_k, ms_p = graph_time_ms(kern, reps), cuda_time_ms(plain, preps)
        ms_l = None
        if lib:
            check_equal(f"{name} library [{shape}]", as_list(lib[0]()), as_list(kern()))
            ms_l = graph_time_ms(lib[0], reps)
        res.update(ms=ms_k, plain_ms=ms_p, library_ms=ms_l, **bnd)
        log(f"# time {name} [{shape}]: exact vs plain; kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})" + (f", library {ms_l:.4f} ms" if lib else ""))


def phase_bitcheck_fr(dev, results: dict) -> None:
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 1)
    spec = bn254_r_spec()
    p = spec.p
    edges = [0, 1, p - 1, (1 << 256) % p]
    ea = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    eb = limb.from_int(spec, [y for _ in edges for y in edges], dev)

    # K1 over F_r at 2^20 pairs, the word edges first
    n = 1 << LOG_N
    err = bitcheck_mont_mul(spec, rng, dev, "mont_mul over F_r")
    results["mont_mul"]["max_abs_err"] = max(results["mont_mul"]["max_abs_err"], err)

    # K5: 2^20 pairs as a (16, R = 2, Bk = 4, c = 512, B = 512) stage input;
    # u and v of the first 16 pairs are the crossed edges; one stage, then
    # log2 r stages on random tables
    x = random_fe(rng, 2 * n, dev).reshape(16, 2, 4, 512, n >> 11)
    x[:, 0, 0, 0, :16], x[:, 0, 0, 256, :16] = ea, eb
    top = nk.k5_radix().bit_length() - 1
    err = 0
    for s in sorted({1, top}):
        tw = random_fe(rng, 512 - (512 >> s), dev)
        err = max(err, check_equal(f"butterfly stages = {s}", [nk.butterfly(spec, x, tw, s)],
                                   [nk.butterfly_ref(spec, x, tw, s)]))

    # K5 at every pass of the m = 2^12 path's transforms (the batched INTT,
    # R = 3, 2^12 points; the batched coset NTT, R = 3, 2^13; the coset INTT,
    # R = 1, 2^13) and of fast_multiply's three 2^9-point transforms; each
    # pass's input is the kernel's previous output; the first transform's
    # passes again on random tables (rows not starting with 1)
    shapes = []
    for k, (R, c, inv) in enumerate(STOCKHAM_TRANSFORMS + FAST_MUL_TRANSFORMS):
        y = random_fe(rng, R * c, dev).reshape(16, R, 1, c, 1)
        for s0, s in ntt._stockham_passes(c):
            tw = ntt._pass_twiddles(spec, c, s0, s, inv, dev)
            tables = [tw] + ([random_fe(rng, tw.shape[1], dev)] if k == 0 else [])
            for twk in tables:
                got = nk.butterfly(spec, y, twk, s)
                err = max(err, check_equal(f"butterfly {tuple(y.shape)} stages = {s}", [got],
                                           [nk.butterfly_ref(spec, y, twk, s)]))
            shapes.append((tuple(y.shape[1:]), s))
            y = nk.butterfly(spec, y, tw, s)
    results["butterfly"] = {"max_abs_err": err}
    log(f"# bitcheck butterfly (r = {nk.k5_radix()}): 2^{LOG_N} pairs (R = 2, Bk = 4, "
        f"c = 512, B = {n >> 11}) + 16 edge pairs at stages = {sorted({1, top})}, and "
        f"every pass of {len(STOCKHAM_TRANSFORMS + FAST_MUL_TRANSFORMS)} transforms "
        f"(R, n, inverse) {STOCKHAM_TRANSFORMS + FAST_MUL_TRANSFORMS}, chained: "
        f"(R, Bk, c, B), stages {shapes}: exact")

    # K6 at every leaf shape of the main paths, then E = 2 with a ragged B
    err = 0
    for E, m, B, inv in sorted(set(leaf_shapes())):
        xl = random_fe(rng, E * m * B, dev).reshape(16, E, m, B)
        twl = ntt._leaf_twiddles(spec, m, inv, dev)
        err = max(err, check_equal(f"ntt_leaf ({E}, {m}, {B}) inverse = {inv}",
                                   [nk.ntt_leaf(spec, xl, twl)],
                                   [nk.ntt_leaf_ref(spec, xl, twl)]))
    for m in (16, 64, 128):
        xl = random_fe(rng, 2 * m * 3000, dev).reshape(16, 2, m, 3000)
        for inv in (False, True):
            twl = ntt._leaf_twiddles(spec, m, inv, dev)
            err = max(err, check_equal(f"ntt_leaf m = {m} inverse = {inv}",
                                       [nk.ntt_leaf(spec, xl, twl)],
                                       [nk.ntt_leaf_ref(spec, xl, twl)]))
    m = nk.MAX_LEAF
    xl = random_fe(rng, 2 * m * 3000, dev).reshape(16, 2, m, 3000)
    for inv in (False, True):
        twl = ntt._leaf_twiddles(spec, m, inv, dev)
        for s in range(1, m.bit_length()):
            err = max(err, check_equal(f"ntt_leaf m = {m} stages = {s} inverse = {inv}",
                                       [nk.ntt_leaf(spec, xl, twl, s)],
                                       [nk.ntt_leaf_ref(spec, xl, twl, s)]))
    # a table of random entries, so that no stage row starts with 1: the
    # kernel must then run the j = 0 products it skips on the paths' tables
    for m in (4, 16, 128):
        xl = random_fe(rng, 2 * m * 3000, dev).reshape(16, 2, m, 3000)
        twl = random_fe(rng, m - 1, dev)
        err = max(err, check_equal(f"ntt_leaf m = {m}, random table",
                                   [nk.ntt_leaf(spec, xl, twl)],
                                   [nk.ntt_leaf_ref(spec, xl, twl)]))
    results["ntt_leaf"] = {"max_abs_err": err}
    log(f"# bitcheck ntt_leaf: the paths' leaves (E, m, B, inverse) "
        f"{sorted(set(leaf_shapes()))}; m = 16, 64, 128, E = 2, B = 3000, "
        f"and m = 128 at every stage count 1..{m.bit_length() - 1}, "
        f"forward and inverse; m = 4, 16, 128 on a random table: exact")
    bitcheck_broadcast(spec, rng, dev, results)

    # segment_sum_mod at 2^20 entries on the card against the same call on
    # the host's CPU and against Python ints: 2^12 segments, the odd ones
    # empty but segment 1, which takes 2^14 entries of r - 1
    nnz, nseg, heavy = n, 1 << 12, 1 << 14
    vals = random_fe(rng, nnz, dev)
    vals[:, :heavy] = limb.from_int(spec, [p - 1], dev)
    segs = 2 * torch.from_numpy(rng.integers(0, nseg // 2, nnz)).to(dev)
    segs[:heavy] = 1
    got = limb.segment_sum_mod(spec, vals, segs, nseg)
    cpu = limb.segment_sum_mod(spec, vals.cpu(), segs.cpu(), nseg)
    if not torch.equal(got.cpu(), cpu):
        raise AssertionError("segment_sum_mod: the card and the CPU disagree")
    want = [0] * nseg
    for v, s in zip(limb.to_int(spec, vals), segs.tolist()):
        want[s] += int(v)
    if [int(x) for x in limb.to_int(spec, got)] != [w % p for w in want]:
        raise AssertionError("segment_sum_mod: disagrees with the host's sums")
    log(f"# bitcheck segment_sum_mod: {nnz} entries into {nseg} segments "
        f"({nseg // 2 - 1} empty, {heavy} x (r - 1) in one): card == CPU == host")


POW_SIZES = (1, 2, 3, 16, 4097)


def pow_exponents(p: int) -> tuple:
    """The chain's exponents: 0, 1, 2, 3, p - 2 and a seeded 256-bit one."""
    return (0, 1, 2, 3, p - 2, random.Random(SEED).getrandbits(256) | 1 << 255)


def phase_bitcheck_pow(dev, results: dict) -> None:
    """K1's chain (limb.pow_const, one launch) over F_q and F_r against its
    plain version and the host's pow(x, e, p)."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, bn254_r_spec

    rng = np.random.default_rng(SEED + 7)
    err = 0
    for spec in (bn254_q_spec(), bn254_r_spec()):
        p, R = spec.p, 1 << 256
        rinv = pow(R, -1, p)
        for n in POW_SIZES:
            a = random_fe(rng, n, dev)
            edges = [0, 1, p - 1, R % p]  # as Montgomery words
            a[:, :min(n, 4)] = limb.from_int(spec, edges[:n], dev)
            xs = [int(v) * rinv % p for v in limb.to_int(spec, a)]
            for e in pow_exponents(p):
                before = _ext.launches["mont_pow"]
                got = limb.pow_const(spec, a, e)
                if _ext.launches["mont_pow"] != before + 1:
                    raise AssertionError("pow_const: not one launch of the chain")
                err = max(err, check_equal(f"mont_pow n = {n} e = {e}", [got],
                                           [limb.mont_pow_ref(spec, a, e)]))
                gi = limb.to_int(spec, got)
                if any(int(g) != pow(x, e, p) * R % p for g, x in zip(gi, xs)):
                    raise AssertionError(f"mont_pow n = {n} e = {e}: differs from the host")
    results["mont_pow"] = {"max_abs_err": err}
    log(f"# bitcheck mont_pow: F_q and F_r, {POW_SIZES} "
        f"elements (0, 1, p - 1, R mod p among them), e = 0, 1, 2, 3, p - 2 and a "
        f"seeded 256-bit e, one launch each: exact vs plain and == host pow(x, e, p)")


def chain_products(e: int, L: int) -> int:
    """Montgomery products an element of K1's chain at exponent e, L limbs:
    the window schedule's table, squarings and window products
    (_ext.window_schedule), the fewest the port's chain needs; the lane
    pair's extra products (one a bit on its acc lane, set or not) are its
    chosen extra work for depth, as K7's pair is."""
    from myzkp_tpu_torch import _ext

    return _ext.schedule_products(_ext.window_schedule(e, _ext.POW_TABLE[L]))


def pow_edge(dev) -> int:
    """The most elements K1's chain runs on the lane pair on this card (the
    launcher's own plan, limb.mont_pow_form, bisected); one more runs in the
    window form."""
    from myzkp_tpu_torch.fields import limb

    lo, hi = 1, 1 << 30
    if limb.mont_pow_form(lo, dev) != "pair" or limb.mont_pow_form(hi, dev) != "wide":
        raise AssertionError("mont_pow_form: no lane pair at 1 element or no window form at 2^30")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if limb.mont_pow_form(mid, dev) == "pair" else (lo, mid)
    return lo


def chain_exponents(p: int) -> tuple:
    """The chain's exponents at every width: 0, 1, 2, 3, alpha, alpha^-1
    (Rescue-Prime's S-boxes), p - 2 and 2^256 - 1."""
    from myzkp_tpu_torch.stark import rescue_constants as rc

    return (0, 1, 2, 3, rc.ALPHA, rc.ALPHA_INV, p - 2, (1 << 256) - 1)


def phase_bitcheck_chain_forms(dev, results: dict) -> None:
    """K1's chain in both of its forms at all three widths: n at the
    launcher's edge (the lane pair) and one past it (the window form), the
    word edges first, each exponent of chain_exponents one launch, exact
    against mont_pow_ref and the edges against the host's pow(x, e, p)."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, m64_spec, m128_spec

    edge = pow_edge(dev)
    rng = random.Random(SEED + 20)
    for spec, name in ((bn254_q_spec(), "mont_pow"), (m128_spec(), "mont_pow_l8"),
                       (m64_spec(), "mont_pow_l4")):
        p, words = spec.p, spec.L // 2
        R = 1 << (32 * words)
        rinv = pow(R, -1, p)
        edges = word_edges(p, words)
        err = 0
        for n in (edge, edge + 1):
            a = limb.from_int(spec, edges + [rng.randrange(p) for _ in range(n - len(edges))],
                              dev).contiguous()
            xs = [x * rinv % p for x in edges]
            for e in chain_exponents(p):
                before = _ext.launches[name]
                got = limb.pow_const(spec, a, e)
                if _ext.launches[name] != before + 1:
                    raise AssertionError(f"pow_const: not one launch of {name}")
                err = max(err, check_equal(f"{name} n = {n} e = {e}", [got],
                                           [limb.mont_pow_ref(spec, a, e)]))
                host = limb.to_int(spec, got[:, :len(edges)])
                if any(int(g) != pow(x, e, p) * R % p for g, x in zip(host, xs)):
                    raise AssertionError(f"{name} n = {n} e = {e}: differs from the host")
        results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0), err)
    log(f"# bitcheck chain forms: mont_pow, mont_pow_l8, mont_pow_l4 at n = {edge} "
        f"({limb.mont_pow_form(edge, dev)}) and {edge + 1} "
        f"({limb.mont_pow_form(edge + 1, dev)}), the word edges first, e = 0, 1, 2, 3, alpha, "
        f"alpha^-1, p - 2, 2^256 - 1, one launch each: exact vs plain and the edges == host")


# K18 (csrc/addsub.cu) at each width: (field's spec function in
# fields/spec.py, 32-bit words, log2 of the timed n or None: F_q shares F_r's
# instance), and the elements of each bitcheck's dense operands.
ADDSUB_WIDTHS = (("bn254_r_spec", 8, 24), ("bn254_q_spec", 8, None), ("m128_spec", 4, 20),
                 ("m64_spec", 2, 20))
LOG_ADDSUB = 16
ADDSUB_REPS = 10  # graph replays of K18 a timing (the int64 chain: 3)


def addsub_layouts(spec, words: int, rng, dev, n: int) -> tuple:
    """({case: (a, b, how K18 takes a and b)}, k): the operand layouts of
    limb.add / sub, each to be held to the plain version on the card.  The
    dense case leads with every pair of the word edges (with 0): limbs at 0
    and 0xFFFF, p - 1, 1, R mod p, and for M128 and M64 values in [R / 2,
    p) whose sums pass R; k is their count.  Read in place: a constant
    (period 1) on either side, a row against a batch of rows (period n) on
    either side, an expanded column (element stride 0), Fp.sum's narrow
    halves (limb stride 2n), a fold's even and odd columns (element stride
    2).  Copied: one side of a general broadcast, a transposed operand."""
    from myzkp_tpu_torch.fields import limb

    L, p = spec.L, spec.p
    edges = word_edges(p, words) + [0]
    k = len(edges) ** 2
    a, b = (random_below(rng, p, L, n, dev) for _ in range(2))
    a[:, :k] = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    b[:, :k] = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    rows = random_below(rng, p, L, 3 * n, dev).reshape(L, 3, n)
    row = b[:, :n]
    wide = random_below(rng, p, L, 2 * n, dev)
    t = random_below(rng, p, L, n, dev).reshape(L, 64, n // 64)
    top = limb.const(spec, p - 1, (), dev)
    col = limb.const(spec, edges[k % len(edges)], (n,), dev)
    h = n // 2
    cases = {
        "dense, the word-edge pairs first": (a, b, "in place, in place"),
        "a constant p - 1 on the right": (a, top, "in place, period 1"),
        "a constant p - 1 on the left": (top, a, "period 1, in place"),
        "a row (L, n) against (L, 3, n) on the right": (rows, row, "in place, period n"),
        "the row on the left": (row, rows, "period n, in place"),
        "an expanded column (L, n), element stride 0": (a, col, "in place, stride 0"),
        "Fp.sum's narrow halves of (L, 2n)": (wide.narrow(1, 0, n), wide.narrow(1, n, n),
                                              "limb stride 2n, limb stride 2n"),
        "a fold's odd and even columns of (L, 2n)": (wide[:, 1::2], wide[:, 0::2],
                                                     "element stride 2, element stride 2"),
        "(L, 3, 1) against (L, 1, n): a general broadcast": (rows[:, :, :1], row[:, None],
                                                               "copied, period n"),
        "a transposed (L, n / 64, 64) against a dense one": (
            t.transpose(1, 2), a.reshape(L, n // 64, 64), "copied, in place"),
        "an empty batch": (a[:, :0], b[:, :0], "no launch"),
    }
    return cases, k


def addsub_plan_text(spec, a, b) -> str:
    """How K18 takes a and b, in the words of addsub_layouts."""
    from myzkp_tpu_torch.fields import limb

    shape = tuple(torch.broadcast_shapes(tuple(a.shape[1:]), tuple(b.shape[1:])))
    n = math.prod(shape)
    if not n:
        return "no launch"

    def say(x):
        plan = limb.addsub_plan(x, shape)
        if plan is None:
            return "copied"
        ls, es, period = plan
        if period < n:
            return f"period {'1' if period == 1 else 'n'}"
        if es == 0:
            return "stride 0"
        if es == 2:
            return "element stride 2"
        return "in place" if ls == n else f"limb stride {'2n' if ls == 2 * n else ls}"
    return f"{say(a)}, {say(b)}"


def bitcheck_addsub(dev) -> dict:
    """K18 at every width against its plain version (add_ref / sub_ref) on
    ``dev`` at every case of addsub_layouts, add and sub, one launch a call
    (none for the empty batch); the edge pairs against the host.  Returns
    {kernel: max_abs_err}."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb, spec as fspec

    rng = np.random.default_rng(SEED + 180)
    n = 1 << LOG_ADDSUB
    errs = {}
    for fn_name, words, _ in ADDSUB_WIDTHS:
        spec = getattr(fspec, fn_name)()
        cases, k = addsub_layouts(spec, words, rng, dev, n)
        R = 1 << (16 * spec.L)
        for case, (a, b, how) in cases.items():
            if addsub_plan_text(spec, a, b) != how:
                raise AssertionError(f"addsub {fn_name} [{case}]: operands taken as "
                                     f"{addsub_plan_text(spec, a, b)}, expected {how}")
            for op, ref, host in ((limb.add, limb.add_ref, lambda x, y: (x + y) % spec.p),
                                  (limb.sub, limb.sub_ref, lambda x, y: (x - y) % spec.p)):
                name = _ext.kernel_name("fe_" + op.__name__, spec)
                before = _ext.launches[name]
                got = op(spec, a, b)
                want = 0 if how == "no launch" else 1
                if _ext.launches[name] != before + want:
                    raise AssertionError(f"{name} [{case}]: {_ext.launches[name] - before} "
                                         f"launches, expected {want}")
                if not got.is_contiguous():
                    raise AssertionError(f"{name} [{case}]: the result is not dense")
                err = check_equal(f"{name} {fn_name} [{case}]", [got], [ref(spec, a, b)])
                errs[name] = max(errs.get(name, 0), err)
                if case.startswith("dense"):
                    xs, ys, gs = (limb.to_int(spec, v[:, :k]) for v in (a, b, got))
                    if any(int(g) != host(int(x), int(y)) for x, y, g in zip(xs, ys, gs)):
                        raise AssertionError(f"{name}: an edge pair differs from the host")
                    if spec.p > R // 2 and op is limb.add and not any(
                            int(x) + int(y) >= R for x, y in zip(xs, ys)):
                        raise AssertionError(f"{name}: no edge pair's sum passes R")
    log(f"# bitcheck fe_add / fe_sub (K18) at L = 16 (F_r, F_q), 8 (M128), 4 (M64): "
        f"{'; '.join(cases)} (n = 2^{LOG_ADDSUB}): exact against add_ref / sub_ref, "
        f"one launch a call, each operand taken as expected (in place or copied); "
        f"the word-edge pairs == host ints, sums past R at M128 and M64")
    return errs


def time_addsub(dev, results: dict) -> None:
    """K18 by graph replay beside its bytes bound (two operands read, one
    result written, 4 B a limb) and the int64 chain it replaced (add_ref /
    sub_ref: graph replay, and CUDA events around its calls as plain_ms):
    dense operands at 2^24 (L = 16) and 2^20 (L = 8, 4), each call on a
    fresh copy of its inputs where they would sit in the L2; at 2^24 also
    a fold's odd and even columns and Fp.sum's halves (a table of 2n read
    once, n written: the dense case's bytes)."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb, spec as fspec

    rng = np.random.default_rng(SEED + 181)
    out = {}
    for fn_name, words, log_n in ADDSUB_WIDTHS:
        if log_n is None:
            continue
        spec = getattr(fspec, fn_name)()
        L, n = spec.L, 1 << log_n
        nbytes = 3 * 4 * L * n
        copies = max(1, -(-(100 << 20) // (2 * 4 * L * n)))
        inputs = [tuple(random_below(rng, spec.p, L, n, dev) for _ in range(2))
                  for _ in range(copies)]
        shapes = {"dense": (inputs, nbytes)}
        if log_n == 24:
            table = random_below(rng, spec.p, L, 2 * n, dev)
            shapes["fold columns"] = ([(table[:, 1::2], table[:, 0::2])], nbytes)
            shapes["sum halves"] = ([(table.narrow(1, 0, n), table.narrow(1, n, n))], nbytes)
        for op, ref in ((limb.add, limb.add_ref), (limb.sub, limb.sub_ref)):
            kname = _ext.kernel_name("fe_" + op.__name__, spec)
            for shape, (ins, nb) in shapes.items():
                pairs = itertools.cycle(ins)
                kept = []

                def kern():
                    r = op(spec, *next(pairs))
                    if copies > 1:
                        kept.append(r)
                    return r
                check_equal(f"{kname} [{shape}]", [op(spec, *ins[0])], [ref(spec, *ins[0])])
                ms = graph_time_ms(kern, ADDSUB_REPS)
                kept.clear()
                chain = graph_time_ms(lambda: ref(spec, *ins[0]), 3)
                bnd = bound(nb, 0)
                row = {"n": n, "ms": ms, "chain_graph_ms": chain, **bnd,
                       "share_of_bound": bnd["bound_ms"] / ms}
                if shape == "dense":
                    row["plain_ms"] = cuda_time_ms(lambda: ref(spec, *ins[0]), 3)
                    results[kname].update(ms=ms, plain_ms=row["plain_ms"], library_ms=None,
                                          **bnd)
                out[f"{kname} {shape}"] = row
                log(f"# time {kname} [{shape}, n = 2^{log_n}]: {ms:.4f} ms, bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                    f"{bnd['bound_ms'] / ms:.1%}); the int64 chain {chain:.4f} ms "
                    f"(graph replay)" + (f", {row['plain_ms']:.4f} ms (events)"
                                          if "plain_ms" in row else ""))
        del inputs, shapes
        torch.cuda.empty_cache()
    results["_addsub"] = out


def phase_addsub(dev, results: dict) -> None:
    for name, err in bitcheck_addsub(dev).items():
        results[name]["max_abs_err"] = err
    time_addsub(dev, results)


def bitcheck_broadcast(spec, rng, dev, results: dict) -> None:
    """K1 with one operand broadcast along leading batch axes, read in place
    with a period, at the broadcasts of the paths (F_r, the 2^21-point
    batched coset NTT of shifted h at 2^20), against the plain version."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.ops import ntt

    n, E = 2 << LOG_M_BIG, 3
    m1, m2 = ntt._fourstep_split(n)
    x = random_fe(rng, E * n, dev).reshape(16, E, n)
    r2_col = limb._limb_column(spec.r2_limbs, 1, dev)
    cases = {
        "1/n constant (16, 1, 1) against (16, 3, n)": (
            x, limb.const(spec, spec.to_mont_int(pow(n, -1, spec.p)), (1, 1), dev)),
        "coset offsets (16, n) against (16, 3, n)": (x, random_fe(rng, n, dev)),
        "level table (16, m1, m2, 1) against (16, 3, m1, m2, 1)": (
            x.reshape(16, E, m1, m2, 1),
            ntt.fourstep_tables(spec, n, False, dev)[0].reshape(16, m1, m2, 1)),
        "to_mont column (16, 1) against (16, n)": (x[:, 0], r2_col),
        "the same, operands swapped": (r2_col, x[:, 0]),
    }
    err = results["mont_mul"]["max_abs_err"]
    for name, (a, b) in cases.items():
        before = _ext.launches["mont_mul"]
        got = limb.mont_mul(spec, a, b)
        if _ext.launches["mont_mul"] != before + 1:
            raise AssertionError(f"mont_mul [{name}]: not one launch")
        err = max(err, check_equal(f"mont_mul [{name}]", [got],
                                   [limb.mont_mul_ref(spec, a, b)]))
    results["mont_mul"]["max_abs_err"] = err
    log(f"# bitcheck mont_mul with a broadcast operand read in place, n = 2^{LOG_M_BIG + 1}: "
        f"{'; '.join(cases)}: exact")


# The transforms of the paths, as the port runs them (ops/ntt.py): Stockham
# (R, n, inverse) of shifted h at m = 2^12, and the K6 leaves (E, m, B,
# inverse) of the four-step recursion of shifted h at m = 2^20 and the NTT.
STOCKHAM_TRANSFORMS = ((3, 1 << LOG_M_SMALL, True), (3, 2 << LOG_M_SMALL, False),
                       (1, 2 << LOG_M_SMALL, True))
# fast_multiply of two 2^8-coefficient inputs (phase 11): two forward
# 2^9-point transforms and one inverse
FAST_MUL_TRANSFORMS = ((1, 1 << 9, False), (1, 1 << 9, False), (1, 1 << 9, True))


def k5_launches(transforms) -> int:
    """K5's launches for the transforms (R, n, inverse): ceil(log2 n / log2
    r) each, r = MYZKP_K5_RADIX of the library in use."""
    from myzkp_tpu_torch.fields import ntt_kernels as nk

    per = nk.k5_radix().bit_length() - 1
    return sum(-(-(n.bit_length() - 1) // per) for _, n, _ in transforms)


def leaf_shapes() -> list:
    from myzkp_tpu_torch.ops import ntt

    out = []
    for E, n, inv in ((3, 1 << LOG_M_BIG, True), (3, 2 << LOG_M_BIG, False),
                      (1, 2 << LOG_M_BIG, True), (1, 1 << LOG_N, False)):
        B, last = 1, n
        for _, m1, m2 in ntt._fourstep_splits(n):
            out.append((E, m1, m2 * B, inv))
            B, last = B * m1, m2
        out.append((E, last, B, inv))
    return out


def horner(coeffs, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def median_ms(fn, reps: int = 5) -> tuple:
    """Median and all reps (ms) of fn on the host clock, each ended by a
    synchronize; the caller has run fn once already."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def counted(fn):
    """fn() run once with every launch count set to 0 first; returns its
    result and the counts that moved."""
    from myzkp_tpu_torch import _ext

    torch.cuda.synchronize()
    _ext.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _ext.launches.items() if v}


def run_counted(counts: dict, secs: dict, name: str, fn):
    """fn() through ``counted`` and ``timed``: its launch counts go to
    counts[name], its seconds to secs[name]; returns its result."""
    (out, counts[name]), secs[name] = timed(lambda: counted(fn))
    return out


def phase_ntt(dev, results: dict) -> None:
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    spec = bn254_r_spec()
    p, n = spec.p, 1 << LOG_N
    rng = random.Random(SEED + 2)
    coeffs = [rng.randrange(p) for _ in range(n)]
    a = Fp.from_int(spec, coeffs, dev)
    ev, counts = counted(lambda: ntt.ntt(a))
    if counts.get("ntt_leaf", 0) < 1:
        raise AssertionError(f"NTT 2^{LOG_N}: K6 never launched: {counts}")
    w = ntt.nth_root_of_unity(p, n)
    ks = rng.sample(range(n), 3)
    got = Fp(spec, ev.mont[:, ks]).to_int()
    if [int(g) for g in got] != [horner(coeffs, pow(w, k, p), p) for k in ks]:
        raise AssertionError(f"NTT 2^{LOG_N}: a(w^k) differs from the host")
    if not torch.equal(ntt.intt(ev).mont, a.mont):
        raise AssertionError(f"NTT 2^{LOG_N}: intt(ntt(a)) != a")
    med, ts = median_ms(lambda: ntt.ntt(a))
    results["_ntt"] = {"ms": med, "reps_ms": ts, "launches": counts}
    log(f"# ntt 2^{LOG_N}: a(w^k) == host at k = {ks}; intt(ntt(a)) == a; "
        f"launches {json.dumps(counts)}; median {med:.3f} ms of "
        f"{[round(t, 3) for t in ts]}")


def phase_shifted_h(dev, log_m: int) -> dict:
    from myzkp_tpu_torch.arith import sparse
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.snark import pinocchio

    spec = bn254_r_spec()
    p, m = spec.p, 1 << log_m
    rng = random.Random(SEED + log_m)
    t0 = time.perf_counter()
    r1cs, asg = sparse.square_chain(spec, m, x0=rng.randrange(2, p), device=dev)
    qap = sparse.SparseQAP(r1cs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    deltas = [rng.randrange(p) for _ in range(3)]
    t0 = time.perf_counter()
    H, counts = counted(lambda: pinocchio.get_shifted_h(qap, asg, *deltas))
    first_s = time.perf_counter() - t0

    ell, r, o = (x.coef.to_int().tolist() for x in qap.combine(asg))
    hc = H.coef.to_int().tolist()
    if len(hc) != m + 1:
        raise AssertionError(f"shifted h 2^{log_m}: {len(hc)} coefficients")
    u = r1cs.left.matvec(asg)
    w = ntt.nth_root_of_unity(p, m)
    js = rng.sample(range(m), 2)
    uj = [int(v) for v in Fp(spec, u.mont[:, js]).to_int()]
    if uj != [horner(ell, pow(w, j, p), p) for j in js]:
        raise AssertionError(f"shifted h 2^{log_m}: ell(w^j) != u_j")
    s = rng.randrange(p)
    t = (pow(s, m, p) - 1) % p
    d_ell, d_r, d_o = deltas
    lhs = ((horner(ell, s, p) + d_ell * t) * (horner(r, s, p) + d_r * t)
           - (horner(o, s, p) + d_o * t))
    if (lhs - horner(hc, s, p) * t) % p:
        raise AssertionError(f"shifted h 2^{log_m}: the Pinocchio identity fails")
    med, ts = median_ms(lambda: pinocchio.get_shifted_h(qap, asg, *deltas))
    log(f"# shifted h m = 2^{log_m}: ell(w^j) == u_j at j = {js}; "
        f"(ell + d_ell t)(r + d_r t) - (o + d_o t) == H t at a random s; "
        f"circuit built in {build_s:.3f} s; first call {first_s:.3f} s")
    log(f"# shifted h m = 2^{log_m} launches: {json.dumps(counts)}")
    log(f"# shifted h m = 2^{log_m}: median {med:.3f} ms of "
        f"{[round(t_, 3) for t_ in ts]}")
    return {"ms": med, "reps_ms": ts, "first_s": first_s, "launches": counts}


def leaf_products(m: int) -> int:
    """The Montgomery products a length-m leaf needs a column: log2(m) stages
    of m / 2 pairs, less the pairs whose twiddle is 1 (j = 0: one a block,
    m - 1 in all), which K6 skips."""
    return m // 2 * (m.bit_length() - 1) - (m - 1)


def k5_pass_bound(R: int, m: int, Bk: int, c: int, s: int) -> dict:
    """The bound of a K5 pass of s stages on (R, Bk, c, 1) of a length-m
    transform: each element read and written once and the pass's table read
    once; the products by twiddles other than 1, m / 2 - Bk 2^t a stage t of
    the pass and R (the j = 0 pair of each block has twiddle 1)."""
    return bound(2 * LIMB_BYTES * R * m + LIMB_BYTES * (c - (c >> s)),
                 R * sum(m // 2 - (Bk << t) for t in range(s)))


def time_ntt_kernels(dev, results: dict) -> None:
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.fields.spec import bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    spec = bn254_r_spec()
    rng = np.random.default_rng(SEED + 3)
    # K6 at the leaf shape of the batched 2^21 coset NTT (three of the nine
    # launches of shifted h at 2^20)
    E, m, B = 3, 128, 1 << 14
    xl = random_fe(rng, E * m * B, dev).reshape(16, E, m, B)
    twl = ntt._leaf_twiddles(spec, m, False, dev)
    time_cases({
        "ntt_leaf": (f"E = {E}, m = {m}, B = {B}: a leaf level of the batched "
                     f"2^{LOG_M_BIG + 1}-point coset NTT",
                     lambda: nk.ntt_leaf(spec, xl, twl),
                     lambda: nk.ntt_leaf_ref(spec, xl, twl), 5, 1,
                     bound(2 * LIMB_BYTES * E * m * B + (m - 1) * LIMB_BYTES,
                           E * B * leaf_products(m)))}, results)
    every = bound(0, E * B * (m // 2) * (m.bit_length() - 1))["bound_ms"]
    log(f"# ntt_leaf: the bound counts the {leaf_products(m)} products a column needs; "
        f"all {m // 2 * (m.bit_length() - 1)} would take {every:.4f} ms")

    # K5 at each pass of the batched 2^13 coset NTT of shifted h at 2^12, on
    # the previous pass's output, then the whole transform: its passes in one
    # graph against the plain version's passes
    R, n = 3, 2 << LOG_M_SMALL
    x = random_fe(rng, R * n, dev).reshape(16, R, n, 1)
    passes, y = [], x.reshape(16, R, 1, n, 1)
    for s0, s in ntt._stockham_passes(n):
        passes.append((y, ntt._pass_twiddles(spec, n, s0, s, False, dev), s))
        y = nk.butterfly(spec, y, passes[-1][1], s)
    per_pass = {}
    for k, (y, tw, s) in enumerate(passes):
        _, _, Bk, c, _ = y.shape
        shape = f"(16, {R}, {Bk}, {c}, 1), stages = {s}"
        per_pass[shape] = {"max_abs_err": 0}
        time_cases({shape: (f"pass {k} of the batched 2^{LOG_M_SMALL + 1}-point coset NTT",
                            lambda: nk.butterfly(spec, y, tw, s),
                            lambda: nk.butterfly_ref(spec, y, tw, s), 100, 3,
                            k5_pass_bound(R, n, Bk, c, s))}, per_pass)

    def plain():
        z = x.reshape(16, R, 1, n, 1)
        for _, tw, s in passes:
            z = nk.butterfly_ref(spec, z, tw, s)
        return z.reshape(x.shape)

    time_cases({"butterfly": (f"the batched 2^{LOG_M_SMALL + 1}-point coset NTT (R = {R}): "
                              f"{len(passes)} launches, r = {nk.k5_radix()}",
                              lambda: ntt._stockham_axis(spec, x, n, False), plain, 20, 3,
                              bound(2 * LIMB_BYTES * R * n + LIMB_BYTES * (n - 1),
                                    R * leaf_products(n)))}, results)
    results["_k5"] = {"radix": nk.k5_radix(), "passes": per_pass,
                      "transform": {k: results["butterfly"][k]
                                    for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def time_k1(dev, results: dict | None) -> dict:
    """K1 and its chain against their plain versions (exact), each timed by
    time_cases: K1 at (16, 8192) (a setup to_mont, the shape timed before),
    at the level-twiddle pass of the batched 2^21-point coset NTT (3 x 2^21
    elements against the level table: the quotient's widest K1 pass), and
    pow_const on 2 elements with e = q - 2 (the proof's inversion).  The
    level pass and the chain go to results (the kernels line); every case
    to the returned dict, printed as '# k1'.  pow_const is also timed with
    CUDA events around its calls in every tree (host time included: what
    it costs a prove), the one method a tree without the chain allows: its
    pow_const is a loop of K1 launches that makes tensors from host data,
    which a graph cannot capture, and is held to the same call on the CPU."""
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_q_spec, bn254_r_spec
    from myzkp_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 14)
    qspec, rspec = bn254_q_spec(), bn254_r_spec()
    a, b = random_fe(rng, 8192, dev), random_fe(rng, 8192, dev)
    n = 2 << LOG_M_BIG
    m1, m2 = ntt._fourstep_split(n)
    xw = random_fe(rng, 3 * n, dev).reshape(16, 3, m1, m2, 1)
    tab = ntt.fourstep_tables(rspec, n, False, dev)[0].reshape(16, m1, m2, 1)
    e = qspec.p - 2
    a2 = random_fe(rng, 2, dev)
    products = 2 * chain_products(e, 16)
    cases = {
        "setup": ("mont_mul", "(16, 8192): a setup to_mont",
                  lambda: limb.mont_mul(qspec, a, b), lambda: limb.mont_mul_ref(qspec, a, b),
                  100, 3, bound(3 * LIMB_BYTES * 8192, 8192)),
        "level": ("mont_mul", f"(16, 3, {m1}, {m2}, 1) x (16, {m1}, {m2}, 1): the "
                  f"level-twiddle pass of the batched 2^{LOG_M_BIG + 1}-point coset NTT",
                  lambda: limb.mont_mul(rspec, xw, tab),
                  lambda: limb.mont_mul_ref(rspec, xw, tab), 20, 1,
                  bound(LIMB_BYTES * (2 * 3 * n + n), 3 * n)),
        "chain": ("mont_pow", "pow_const, 2 elements, e = q - 2: the proof's inversion",
                  lambda: limb.pow_const(qspec, a2, e),
                  lambda: limb.mont_pow_ref(qspec, a2, e), 20, 1,
                  bound(2 * 2 * LIMB_BYTES, products)),
    }
    call = lambda: limb.pow_const(qspec, a2, e)
    check_equal("pow_const", [call()], [limb.pow_const(qspec, a2.cpu(), e).to(dev)])
    out = {"inversion_events_ms": cuda_time_ms(call, 5)}
    log(f"# time pow_const [2 elements, e = q - 2]: exact vs the CPU; "
        f"{out['inversion_events_ms']:.4f} ms a call (CUDA events around the calls)")
    if not hasattr(limb, "mont_pow_ref"):
        del cases["chain"]
    if hasattr(limb, "mont_pow_form"):
        # one product's latency: the lane pair on one element is one product
        # deep a bit, at 256 bits less at 17, over 239
        one = a2[:, :1].contiguous()
        lat = [graph_time_ms(lambda: limb.pow_const(qspec, one, 1 << k), 5) for k in (16, 255)]
        out["product_latency_us"] = (lat[1] - lat[0]) / 239 * 1e3
        out["chain_depth_bound_ms"] = e.bit_length() * out["product_latency_us"] * 1e-3
        log(f"# time one product's latency on one warp (the lane pair on one element, "
            f"2^255 less 2^16, over 239): {out['product_latency_us']:.4f} us; the inversion's "
            f"depth bound {e.bit_length()} x that = {out['chain_depth_bound_ms']:.4f} ms")
    for key, (name, what, kern, plain, reps, preps, bnd) in cases.items():
        res = {name: {"max_abs_err": 0}}
        time_cases({name: (what, kern, plain, reps, preps, bnd)}, res)
        out[key] = res[name]
        if results is not None and key != "setup":
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               res[name]["max_abs_err"])
            results[name].update({k: res[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by", "library_ms")})
    if results is not None and "chain_depth_bound_ms" in out:
        results["mont_pow"]["depth_bound_ms"] = out["chain_depth_bound_ms"]
    log(f"# k1 {json.dumps(out)}")
    return out


# The 2^20 MSM's lanes, G * n / K (c = 16, G = 2, K = 64): the width of the
# bucket scan and of the lane merge's adds
SCAN_LANES = 1 << 15
# Montgomery products of a G2 complete add: the function needs 14 F_q2
# products of 3 (Karatsuba, csrc/fq2.cuh), which the bounds count; K7's lane
# pair does 4 an F_q2 product (csrc/pair.cuh), its chosen extra work
G2_ADD_PRODUCTS = 42
PAIR_G2_ADD_PRODUCTS = 56
# The H100's L2 cache: a kernel timed against the memory rate reads inputs
# that are not in it (cold_calls)
L2_BYTES = 50 * 2**20


def fq2_rescale(F, pt, lam):
    """Projective rescaling (x, y, z) -> (lam x, lam y, lam z) over F_q2."""
    return tuple(F.mul(c, lam) for c in pt)


def phase_bitcheck_g2(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

    rng = np.random.default_rng(SEED + 4)
    spec = bn254.q_spec()
    p = spec.p
    F, b3 = bn254.g2_ops(), bn254.g2_b3((), dev)
    g = bn254.g2_generator()
    hrng = random.Random(SEED + 4)
    host = [g * hrng.randrange(1, bn254.R) for _ in range(63)]
    host.append(bn254.curve_g2.infinity())
    base = bn254.g2_points_to_device(host, dev)
    m = SCAN_LANES
    ia = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    ib = torch.from_numpy(rng.integers(0, 64, m)).to(dev)
    kinds = torch.from_numpy(rng.integers(0, 8, m)).to(dev)
    ib = torch.where(kinds == 0, ia, ib)  # P + P
    ib = torch.where(kinds == 1, torch.full_like(ib, 63), ib)  # P + O
    ia = torch.where(kinds == 2, torch.full_like(ia, 63), ia)  # O + Q
    ia = torch.where(kinds == 3, torch.full_like(ia, 63), ia)  # O + O
    ib = torch.where(kinds == 3, torch.full_like(ib, 63), ib)

    def rescaled(idx):  # z != 1: a random F_q2 factor per lane
        lam = (random_fe(rng, m, dev), random_fe(rng, m, dev))
        lam[0][0] |= 1  # nonzero
        return fq2_rescale(F, tuple((c[0][:, idx], c[1][:, idx]) for c in base), lam)

    P, Q = rescaled(ia), rescaled(ib)
    negate = kinds == 4  # P + (-P)
    Q = tuple(F.select(negate, pc, qc) for pc, qc in zip((P[0], F.neg(P[1]), P[2]), Q))
    # the first m / 8 lanes: every coordinate component, c0 and c1 of x, y,
    # z of P and Q, drawn from 0, 1, q - 1 and R mod q (not points)
    edges = [0, 1, p - 1, (1 << 256) % p]
    E = m // 8
    P, Q = ([[c.clone() for c in coord] for coord in pt] for pt in (P, Q))
    for coord in (*P, *Q):
        for c in coord:
            c[:, :E] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, E)], dev)
    P, Q = (tuple(tuple(coord) for coord in pt) for pt in (P, Q))
    h = torch.from_numpy(rng.integers(0, 2, m).astype(bool)).to(dev)
    L = lambda pt: list(wst.leaves(pt))
    err = check_equal("padd2", L(ck.padd2(spec, b3, P, Q)), L(ck.padd2_ref(spec, b3, P, Q)))
    err = max(err, check_equal("padd2(h)", L(ck.padd2(spec, b3, P, Q, h)),
                               L(ck.padd2_ref(spec, b3, P, Q, h))))
    sums = ck.padd2(spec, b3, P, Q)
    got = bn254.g2_points_to_host(wst.point_map(lambda c: c[:, E:E + 64], wst.Point(*sums)))
    ha, hb, kk = (t[E:E + 64].tolist() for t in (ia, ib, kinds))
    want = [host[x] + (-host[x] if k == 4 else host[y]) for x, y, k in zip(ha, hb, kk)]
    if got != want:
        raise AssertionError("padd2: disagrees with the host group law")
    # one tree level of the G2 fixed base: (W / 2) * chunk lanes
    tree_w = (-(-256 // 8) // 2) * fixed_base._CHUNK
    reps = tree_w // m
    wide = lambda pt: tuple(tuple(c.repeat(1, reps) for c in coord) for coord in pt)
    Pw, Qw = wide(P), wide(Q)
    err = max(err, check_equal(f"padd2 [{tree_w} lanes]", L(ck.padd2(spec, b3, Pw, Qw)),
                               L(ck.padd2_ref(spec, b3, Pw, Qw))))
    del Pw, Qw
    results["padd2"] = {"max_abs_err": err}
    log(f"# bitcheck padd2: {m} lanes (P+P, P+(-P), P+O, O+Q, O+O, z != 1; "
        f"{E} lanes of 0, 1, q-1, R mod q in every c0 and c1), with and without h, "
        f"and {tree_w} lanes (a fixed-base tree level): exact; 64 sums match the host")
    err = check_equal("pdbl2", L(ck.pdbl2(spec, b3, P)), L(ck.pdbl2_ref(spec, b3, P)))
    dbl = bn254.g2_points_to_host(
        wst.point_map(lambda c: c[:, E:E + 64], wst.Point(*ck.pdbl2(spec, b3, P))))
    if dbl != [host[x] + host[x] for x in ha]:
        raise AssertionError("pdbl2: disagrees with the host group law")
    results["pdbl2"] = {"max_abs_err": err}
    log(f"# bitcheck pdbl2: {m} lanes incl. O and the edge lanes: exact; "
        f"64 match the host")
    # K4's G2 instance at N = 3000 lanes (ragged), K = 4
    rows, _ = msm._rows_of_point(wst.point_map(lambda c: c[:, :4 * 3000], wst.Point(*P)))
    err = bitcheck_scan(spec, F, b3, rows, 4, rng, dev)
    results["bucket_scan_rows2"] = {"max_abs_err": err}
    log(f"# bitcheck bucket_scan_rows2: {SCAN_CASE}: acc and bucket table exact")


# The point-row moves K14 and K16 at the path's shapes: a fixed-base chunk
# (32 windows of the 2^8-entry table for 2^18 scalars: 8,388,608 int32
# indices into 8,192 rows), the lane merge's (G, B) = (2, 16,384) targets
# (int64, into the 2 x (2^15 + 2)-row bucket table of the 2^20 MSM, c = 16),
# the 2^20-point MSM table, and ragged sizes.
FB_ROWS, FB_INDICES = 32 << 8, 32 << 18
MERGE_TABLE, MERGE_POINTS = 2 * ((1 << 15) + 2), SCAN_LANES
ROW_TAILS = (1, 33, 4099)


def random_rows(spec, rng, nt: int, C: int, W: int, dev) -> torch.Tensor:
    """An (nt, W) int32 point table: random 16-bit limbs in the C used
    columns, zeros after, and 0, 1, q - 1, R mod q in every coordinate
    component of the first nt / 8 rows and of the last."""
    from myzkp_tpu_torch.fields import limb

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    t = torch.randint(0, 1 << 16, (nt, W), generator=gen, dtype=torch.int32, device=dev)
    t[:, C:] = 0
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    e = max(1, nt // 8)
    at = torch.cat([torch.arange(e - 1, device=dev), torch.tensor([nt - 1], device=dev)])
    for j in range(C // 16):
        vals = [edges[i] for i in rng.integers(0, 4, at.numel())]
        t[at, 16 * j:16 * j + 16] = limb.from_int(spec, vals, dev).T
    return t


def random_leaves(spec, C: int, n: int, rng, dev) -> list:
    """The C / 16 coordinate tensors of n points, (16, n) int32: the
    columns of a random table's used limbs."""
    t = random_rows(spec, rng, n, C, C, dev)
    return [t[:, 16 * j:16 * j + 16].T.contiguous() for j in range(C // 16)]


def fixed_base_indices(rng, dev) -> torch.Tensor:
    """A fixed-base chunk's gather indices, as fixed_base_multi makes them:
    window w's digit of each of the FB_INDICES / 32 scalars, offset by w *
    2^8, int32, window-major."""
    digits = rng.integers(0, 256, (32, FB_INDICES // 32)) + (np.arange(32) << 8)[:, None]
    return torch.from_numpy(digits.reshape(-1).astype(np.int32)).to(dev)


def repeating(rng, nt: int, n: int, dtype, dev) -> torch.Tensor:
    """n indices below nt at random, each of the first n / 16 repeated once
    more at random places."""
    idx = rng.integers(0, nt, n)
    k = max(1, n // 16)
    idx[rng.integers(0, n, k)] = idx[:k]
    return torch.from_numpy(idx).to(dtype).to(dev)


def phase_bitcheck_rows(dev, results: dict) -> None:
    """K14 (gather_planes) and K16 (scatter_rows) against their plain
    versions, exact, in both groups (C = 48, W = 64; C = 96, W = 128).  K14:
    at a fixed-base chunk's indices (int32, the digits of every window), at
    the lane merge's targets (int64, random, repeating) and with no indices
    over the whole bucket table, at ragged sizes with random repeating
    indices and with none; K16: the 2^20-point MSM table (no targets), the
    merge's scatter of 32,768 points at int64 targets of which 1 in 16
    repeat (the tables compared on the rows no two points target; the MSM
    drops its only repeated rows), and ragged sizes with unique targets and
    with none, every write over a table of other values, so the zero pad
    columns and the rows left alone are checked too.  Tables and points:
    random limbs with rows of 0, 1, q - 1, R mod q in every coordinate
    component.  Then each timed at the path's shapes beside its plain
    version, its bound and the PyTorch calls it replaced (library_ms): K14
    at the fixed-base chunk (index_select, then the transpose's copy) and
    at the merge's two gathers (the indexing and the transpose), with cold
    inputs; K16 at 2^20 points (cat, transpose, pad, copy) and at the
    merge's scatter (the same, then index_put_)."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck

    rng = np.random.default_rng(SEED + 14)
    spec = bn254.q_spec()
    errs = {"gather_planes": 0, "scatter_rows": 0}
    timed = {}
    for group, C, W in (("g1", 48, 64), ("g2", 96, 128)):
        # K14
        gathers = [("fixed-base chunk", FB_ROWS, fixed_base_indices(rng, dev)),
                   ("merge targets", MERGE_TABLE,
                    repeating(rng, MERGE_TABLE, MERGE_POINTS, torch.int64, dev)),
                   ("merge table", MERGE_TABLE, None)]
        for n in ROW_TAILS:
            gathers += [(f"ragged n = {n}", 1000, repeating(rng, 1000, n, torch.int32, dev)),
                        (f"ragged {n} rows", n, None)]
        for what, nt, idx in gathers:
            table = random_rows(spec, rng, nt, C, W, dev)
            errs["gather_planes"] = max(errs["gather_planes"], check_equal(
                f"gather_planes [{group}, {what}]", [ck.gather_planes(table, idx, C)],
                [ck.gather_planes_ref(table, idx, C)]))
        del table, gathers
        # K16
        scatters = [("2^20 points", 1 << LOG_N, 1 << LOG_N, None),
                    ("merge", MERGE_POINTS, MERGE_TABLE,
                     repeating(rng, MERGE_TABLE, MERGE_POINTS, torch.int64, dev))]
        for n in ROW_TAILS:
            scatters += [(f"ragged n = {n}", n, n + 50, torch.from_numpy(
                              rng.permutation(n + 50)[:n].astype(np.int32)).to(dev)),
                         (f"ragged {n} rows", n, n + 50, None)]
        for what, n, S, tgt in scatters:
            leaves = random_leaves(spec, C, n, rng, dev)
            base = random_rows(spec, rng, S, W, W, dev)  # other values, pad included
            out_k, out_p = base.clone(), base.clone()
            ck.scatter_rows(leaves, out_k, tgt)
            ck.scatter_rows_ref(leaves, out_p, tgt)
            keep = torch.ones(S, dtype=torch.bool, device=dev)
            if tgt is not None:
                hits = torch.bincount(tgt.long(), minlength=S)
                keep = hits <= 1
            errs["scatter_rows"] = max(errs["scatter_rows"], check_equal(
                f"scatter_rows [{group}, {what}]", [out_k[keep]], [out_p[keep]]))
        del leaves, base, out_k, out_p, scatters
        torch.cuda.synchronize()
        log(f"# bitcheck gather_planes, scatter_rows [{group}]: a fixed-base chunk "
            f"({FB_INDICES} int32 indices into {FB_ROWS} rows), the merge's {MERGE_POINTS} "
            f"int64 repeating targets and its {MERGE_TABLE}-row table, 2^{LOG_N} points, "
            f"ragged n = {ROW_TAILS} with random repeating indices / unique targets and "
            f"with none: exact (repeated targets' rows left out)")
        timed[group] = time_rows(spec, C, W, rng, dev)
    for k, e in errs.items():
        results[k] = {"max_abs_err": e}
    # the kernels line: G1 at the fixed-base chunk (K14) and 2^20 points (K16)
    for k in errs:
        results[k].update({f: timed["g1"][k][f] for f in
                           ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    results["_rows"] = timed


def time_rows(spec, C: int, W: int, rng, dev) -> dict:
    """K14 and K16 of one group timed at the path's shapes (phase_bitcheck_rows);
    returns {case: timings}."""
    from myzkp_tpu_torch.curves import curve_kernels as ck

    out = {}
    # the bytes a gather must move: the used limbs of each distinct row it
    # reads, once; its indices; the planes it writes
    gather_bytes = lambda ix, n: ((n if ix is None else int(ix.unique().numel())) * 4 * C
                                  + (0 if ix is None else ix.nbytes) + n * 4 * C)

    def case(key, shape, kern, plain, lib, nbytes, reps=5):
        name = key.split()[0]  # the kernel: gather_planes or scatter_rows
        res = {name: {"max_abs_err": 0}}
        time_cases({name: (shape, kern, plain, reps, 1, bound(nbytes, 0), lib)}, res)
        out[key] = res[name]

    old_planes = lambda rows: rows[:, :C].T.contiguous()
    table = random_rows(spec, rng, FB_ROWS, C, W, dev)
    idx = fixed_base_indices(rng, dev)
    n = FB_INDICES
    case("gather_planes", f"fixed-base chunk: {n} int32 indices into {FB_ROWS} rows",
         lambda: ck.gather_planes(table, idx, C), lambda: ck.gather_planes_ref(table, idx, C),
         lambda: old_planes(table.index_select(0, idx)), gather_bytes(idx, n), reps=3)
    out["gather_planes"]["one_call_ms"] = graph_time_ms(
        lambda: table[:, :C].T.index_select(1, idx), 3)
    del table, idx
    # the merge's gathers, each call on its own copy of the bucket table:
    # enough copies that the bytes between two uses of one pass the L2
    base = random_rows(spec, rng, MERGE_TABLE, C, W, dev)
    copies = [base] + [base.clone() for _ in range(2 * L2_BYTES // base.nbytes + 1)]
    tgt = repeating(rng, MERGE_TABLE, MERGE_POINTS, torch.int64, dev)
    for key, ix, n in (("gather_planes merge targets", tgt, MERGE_POINTS),
                       ("gather_planes merge table", None, MERGE_TABLE)):
        kern, kept = cold_calls(lambda t, ix=ix: ck.gather_planes(t, ix, C), copies)
        lib, kept_l = cold_calls(lambda t, ix=ix: old_planes(t if ix is None else t[ix]),
                                 copies)
        case(key, f"{n} points from the {MERGE_TABLE}-row bucket table, "
                  f"{'int64 targets' if ix is not None else 'every row'}; inputs cold "
                  f"({len(copies)} copies)",
             kern, lambda ix=ix: ck.gather_planes_ref(copies[0], ix, C), lib,
             gather_bytes(ix, n), reps=50)
        kept.clear()
        kept_l.clear()
    leaves = random_leaves(spec, C, 1 << LOG_N, rng, dev)
    rows_k = torch.empty((1 << LOG_N, W), dtype=torch.int32, device=dev)
    rows_p = torch.empty_like(rows_k)
    old_rows = lambda ls: torch.nn.functional.pad(torch.cat(ls, dim=0).T,
                                                  (0, W - C)).contiguous()
    case("scatter_rows", f"2^{LOG_N} points into a new table",
         lambda: ck.scatter_rows(leaves, rows_k), lambda: ck.scatter_rows_ref(leaves, rows_p),
         lambda: old_rows(leaves), (1 << LOG_N) * (4 * C + 4 * W))
    del leaves, rows_k, rows_p
    leaves = random_leaves(spec, C, MERGE_POINTS, rng, dev)
    uniq = torch.from_numpy(rng.permutation(MERGE_TABLE)[:MERGE_POINTS]).to(dev)
    t_k, t_p, t_l = (base.clone() for _ in range(3))

    def index_put(ls):
        t_l[uniq] = old_rows(ls)
        return t_l
    case("scatter_rows merge", f"{MERGE_POINTS} points at int64 targets into the "
                               f"{MERGE_TABLE}-row bucket table",
         lambda: ck.scatter_rows(leaves, t_k, uniq),
         lambda: ck.scatter_rows_ref(leaves, t_p, uniq), lambda: index_put(leaves),
         MERGE_POINTS * (4 * C + 8 + 4 * W), reps=50)
    del copies, base
    return out


# Tail lengths for the add kernels: not multiples of a block (64 or 128
# threads), of a warp's 16 lane pairs, or of 2.
TAILS = (1, 17, 63, 65, 4097, SCAN_LANES - 5)
# A width of K2 above 2^17 points, where wider launches than the lane merge's
# run (the fixed-base setup's tree levels)
K2_WIDE = (1 << 17) + 5


def level_inputs(group: str, rows: int, B: int, rng, dev):
    """(F, b3, x) over a (rows, B) batch: random canonical coordinates, every
    component of 1 lane in 8 drawn from 0, 1, q - 1 and R mod q, and 1 lane
    in 16 infinity (0, 1, 0).  The formulas do not need points on the curve
    to be held bit for bit to their plain versions."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.fields import limb

    g2 = group == "g2"
    spec = bn254.q_spec()
    F, b3 = ((bn254.g2_ops(), bn254.g2_b3((), dev)) if g2
             else (bn254.g1_ops(), bn254.g1_b3((), dev)))
    n = rows * B
    E, I = -(-n // 8), -(-n // 16)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    at = torch.from_numpy(rng.choice(n, E, replace=False)).to(dev)
    inf_at = torch.from_numpy(rng.choice(n, I, replace=False)).to(dev)
    one = limb.one_mont(spec, (I,), dev)
    comps = []
    for k in range(6 if g2 else 3):
        c = random_fe(rng, n, dev)
        c[:, at] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, E)], dev)
        c[:, inf_at] = one if k == (2 if g2 else 1) else torch.zeros_like(one)
        comps.append(c.reshape(16, rows, B))
    x = tuple(zip(comps[0::2], comps[1::2])) if g2 else tuple(comps)
    return F, b3, x


def level_heads(kind: str, rows: int, B: int, rng, dev) -> torch.Tensor:
    """Segment heads: every lane, lane 0 only, 3 lanes in 10 with lane 0
    clear (lanes below d then add infinity), or 97 in 100 with lane 0 set."""
    lane = np.arange(B)[None, :].repeat(rows, 0)
    h = {"all": np.ones((rows, B), bool), "lane0": lane == 0,
         "random": (rng.random((rows, B)) < 0.3) & (lane > 0),
         "dense": (rng.random((rows, B)) < 0.97) | (lane == 0)}[kind]
    return torch.from_numpy(h).to(dev)


def phase_bitcheck_levels(dev, results: dict) -> None:
    """K2 and K7 with the mask on 1 lane in 32 and at tail lengths; the
    lane-merge levels of both groups against their plain versions, every
    level of the scan at the lane merge's (2, 16384) shape under four head
    patterns, and at a ragged (3, 1000); then msm._seg_scan_hs on the card
    against the plain levels."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    rng = np.random.default_rng(SEED + 11)
    spec = bn254.q_spec()
    L = lambda pt: list(wst.leaves(wst.Point(*pt)))
    errs = {k: 0 for k in ("padd", "padd2", "padd_seg_level", "padd2_seg_level")}
    for group, add, ref in (("g1", ck.padd, ck.padd_ref), ("g2", ck.padd2, ck.padd2_ref)):
        name = "padd2" if group == "g2" else "padd"
        for n in (SCAN_LANES,) + (K2_WIDE,) * (group == "g1") + TAILS:
            F, b3, P = level_inputs(group, 1, n, rng, dev)
            _, _, Q = level_inputs(group, 1, n, rng, dev)
            flat = lambda pt: tuple(wst.point_map(lambda c: c.reshape(16, n),
                                                  wst.Point(*pt)))
            P, Q = flat(P), flat(Q)
            lane = torch.arange(n, device=dev)
            same, opp = lane % 7 == 3, lane % 7 == 4  # Q = P, Q = -P
            Q = (F.select(same | opp, P[0], Q[0]),
                 F.select(opp, F.neg(P[1]), F.select(same, P[1], Q[1])),
                 F.select(same | opp, P[2], Q[2]))
            h = lane % 32 == 5
            for hh in (None, h):
                errs[name] = max(errs[name], check_equal(
                    f"{name} [{n} lanes, h {'1 in 32' if hh is not None else 'none'}]",
                    L(add(spec, b3, P, Q, hh)), L(ref(spec, b3, P, Q, hh))))
    log(f"# bitcheck padd, padd2: {SCAN_LANES} lanes, padd at {K2_WIDE} too, and tails "
        f"{TAILS}, with h on 1 lane in 32 and without; 1 lane in 8 of 0, 1, q - 1, "
        f"R mod q in every component, 1 in 16 infinity on either side, Q = P on 1 "
        f"lane in 7 and Q = -P on another: exact")

    for group in ("g1", "g2"):
        name = "padd2_seg_level" if group == "g2" else "padd_seg_level"
        level = ck.padd2_seg_level if group == "g2" else ck.padd_seg_level
        ref = ck.padd2_seg_level_ref if group == "g2" else ck.padd_seg_level_ref
        for rows, B in ((2, SCAN_LANES // 2), (3, 1000)):
            F, b3, x0 = level_inputs(group, rows, B, rng, dev)
            for kind in ("all", "lane0", "random", "dense"):
                x, flags = x0, level_heads(kind, rows, B, rng, dev)
                d = 1
                while d < B:
                    got, gf = level(spec, b3, x, flags, d)
                    want, wf = ref(spec, b3, x, flags, d)
                    errs[name] = max(errs[name], check_equal(
                        f"{name} [({rows}, {B}), heads {kind}, d = {d}]",
                        L(got) + [gf], L(want) + [wf]))
                    x, flags, d = got, gf, 2 * d
        # the whole scan through msm._seg_scan_hs: one launch a level
        F, b3, x = level_inputs(group, 2, SCAN_LANES // 2, rng, dev)
        heads = level_heads("random", 2, SCAN_LANES // 2, rng, dev)
        got, counts = counted(lambda: msm._seg_scan_hs(F, b3, wst.Point(*x), heads))
        xr, fr, d = x, heads, 1
        while d < SCAN_LANES // 2:
            xr, fr = ref(spec, b3, xr, fr, d)
            d *= 2
        errs[name] = max(errs[name], check_equal(f"{name} [_seg_scan_hs]",
                                                 L(got), L(xr)))
        levels = (SCAN_LANES // 2 - 1).bit_length()
        if counts != {name: levels}:
            raise AssertionError(f"_seg_scan_hs ({group}): launches {counts}, expected "
                                 f"{levels} of {name} and nothing else")
        log(f"# bitcheck {name}: every level d = 1 .. {SCAN_LANES // 4} at (2, "
            f"{SCAN_LANES // 2}) and d = 1 .. 512 at (3, 1000), heads all / lane 0 only "
            f"/ 3 in 10 with lane 0 clear / 97 in 100; 1 lane in 8 of edge values, 1 in "
            f"16 infinity: out and flags exact; _seg_scan_hs at (2, {SCAN_LANES // 2}): "
            f"exact, {levels} launches of {name} and nothing else")
    for k, e in errs.items():
        results[k]["max_abs_err"] = max(results[k].get("max_abs_err", 0), e)


# The chains of doublings (K3, K8): the widths of their bitchecks (one point:
# Horner and the ladders' bases; a window batch: the window sums' top
# buckets; a wide batch with a tail) and their step counts (one double, a
# Horner window of c = 16, a ladder's 255 bases)
CHAIN_WIDTHS = {"g1": (1, 16, (1 << 16) + 3), "g2": (1, 16, SCAN_LANES + 5)}
CHAIN_STEPS = (1, 16, 255)


def chain_inputs(group: str, n: int, rng, dev):
    """(F, b3, P, host) over n lanes for K3 (G1) or K8 (G2), by lane % 16:
    10 infinity (0, lam y, 0), 11 y = 0 (where P = -P; not a point), 12 and
    13 every coordinate component 0, 1, q - 1 or R mod q; every other lane a
    projective rescaling by a random lam of one of 64 host points, which
    host(lanes) returns."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

    g2 = group == "g2"
    spec = bn254.q_spec()
    F, b3 = ((bn254.g2_ops(), bn254.g2_b3((), dev)) if g2
             else (bn254.g1_ops(), bn254.g1_b3((), dev)))
    gen = bn254.g2_generator() if g2 else bn254.g1_generator()
    to_device = bn254.g2_points_to_device if g2 else bn254.g1_points_to_device
    hrng = random.Random(SEED + 12 + g2)
    host = [gen * hrng.randrange(1, bn254.R) for _ in range(64)]
    idx = rng.integers(0, 64, n)
    lam = ((random_fe(rng, n, dev), random_fe(rng, n, dev)) if g2
           else random_fe(rng, n, dev))
    (lam[0] if g2 else lam)[0] |= 1  # nonzero
    P = wst.Point(*(F.mul(c, lam) for c in wst.point_map(
        lambda c: c[:, torch.from_numpy(idx).to(dev)], to_device(host, dev))))
    kind = torch.arange(n, device=dev) % 16
    edge = (kind == 12) | (kind == 13)
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    comps = 2 if g2 else 1
    leaves = [c.clone() for c in wst.leaves(P)]
    for j, c in enumerate(leaves):
        c[:, kind == (11 if j // comps == 1 else 10)] = 0
        k = int(edge.sum())
        if k:
            c[:, edge] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, k)], dev)
    return F, b3, wst.from_leaves(leaves), lambda lanes: [host[idx[i]] for i in lanes]


def phase_bitcheck_chains(dev, results: dict) -> None:
    """K3 and K8 chains against their plain versions and the host group law:
    at each width of CHAIN_WIDTHS, the plain version's 255 steps once, then
    the kernel at n = 1, 16 and 255, with and without the steps output, each
    exact against the plain version's step n (or steps 1 .. n); on up to 16
    point lanes of each width, 2^n P equal to the host's."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    rng = np.random.default_rng(SEED + 12)
    spec = bn254.q_spec()
    nmax = max(CHAIN_STEPS)
    for group in ("g1", "g2"):
        g2 = group == "g2"
        name = "pdbl2" if g2 else "pdbl"
        wrap, ref = (ck.pdbl2, ck.pdbl2_ref) if g2 else (ck.pdbl, ck.pdbl_ref)
        to_host = bn254.g2_points_to_host if g2 else bn254.g1_points_to_host
        err = results[name]["max_abs_err"]
        for width in CHAIN_WIDTHS[group]:
            F, b3, P, host = chain_inputs(group, width, rng, dev)
            want = wst.leaves(wst.Point(*ref(spec, b3, P, nmax, steps=True)))
            pts = [i for i in range(width) if i % 16 not in (10, 11, 12, 13)][:16]
            lanes = torch.tensor(pts, device=dev)
            for n in CHAIN_STEPS:
                got = wst.leaves(wst.Point(*wrap(spec, b3, P, n)))
                err = max(err, check_equal(f"{name} [{width} points, n = {n}]", got,
                                           [w[n - 1] for w in want]))
                got = wst.leaves(wst.Point(*wrap(spec, b3, P, n, steps=True)))
                err = max(err, check_equal(f"{name} [{width} points, n = {n}, steps]",
                                           got, [w[:n] for w in want]))
                k = 1 << n
                last = wst.point_map(lambda c: c[n - 1][:, lanes], wst.from_leaves(got))
                if to_host(last) != [p * (k % bn254.R) for p in host(pts)]:
                    raise AssertionError(f"{name} [{width} points, n = {n}]: 2^n P "
                                         f"disagrees with the host group law")
            del want, got
        results[name]["max_abs_err"] = err
        log(f"# bitcheck {name} chains: widths {CHAIN_WIDTHS[group]}, n = {CHAIN_STEPS}, "
            f"with and without the steps output, exact against the plain version's "
            f"{nmax} steps; by lane % 16 infinity, y = 0 (P = -P), two lanes of 0, 1, "
            f"q - 1, R mod q in every component; 2^n P == host on up to 16 point "
            f"lanes a width")


def chain_call(fn, spec, b3, p, n: int, steps: bool = False):
    """n doublings of p by fn, K3's or K8's wrapper or plain version: one call
    where fn takes n; else (a tree from before the chain kernels, whose
    kernels smoke_graph_timed.py times through this) n calls, every step
    kept when steps is set."""
    import inspect

    if "n" in inspect.signature(fn).parameters:
        return fn(spec, b3, p, n, steps=steps)
    out = []
    for _ in range(n):
        p = fn(spec, b3, p)
        out.append(p)
    return out if steps else p


def flat(x) -> list:
    """The tensors of nested tuples and lists, in order."""
    return [x] if torch.is_tensor(x) else [t for e in x for t in flat(e)]


# (group, points, n, steps, reps, what): the chains timed, at the prover's
# shapes and at the shape each kernel was timed at before the chains
CHAIN_SHAPES = (
    ("g1", 16, 1, False, 100, "16 points, n = 1: the window sums' top buckets, one double"),
    ("g1", 1, 16, False, 20, "1 point, n = 16: a Horner window"),
    ("g1", 1, 255, True, 4, "1 point, n = 255, every step: a ladder's bases"),
    ("g2", SCAN_LANES, 1, False, 20, f"{SCAN_LANES} lanes, n = 1"),
    ("g2", 1, 16, False, 20, "1 point, n = 16: a Horner window"),
    ("g2", 1, 255, True, 4, "1 point, n = 255, every step: a ladder's bases"),
)


def time_chains(dev, results: dict | None) -> dict:
    """K3 and K8 at CHAIN_SHAPES against their plain versions (exact), each
    timed by time_cases, with the bound of its inputs: 9 (G1) or 25 (G2)
    Montgomery products a double a point against reading P and writing 2^n P
    (or every step).  The Horner window's times go to results (the kernels
    line); every shape's to the returned dict, printed as '# chains'."""
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck

    rng = np.random.default_rng(SEED + 13)
    spec = bn254.q_spec()
    out = {}
    for group, pts, n, steps, reps, what in CHAIN_SHAPES:
        g2 = group == "g2"
        name = "pdbl2" if g2 else "pdbl"
        wrap, ref = (ck.pdbl2, ck.pdbl2_ref) if g2 else (ck.pdbl, ck.pdbl_ref)
        b3 = bn254.g2_b3((), dev) if g2 else bn254.g1_b3((), dev)
        fe = lambda: random_fe(rng, pts, dev)
        P = tuple((fe(), fe()) for _ in range(3)) if g2 else tuple(fe() for _ in range(3))
        comps = 2 if g2 else 1
        nbytes = comps * LIMB_BYTES * (3 + 3 * (n if steps else 1)) * pts + comps * LIMB_BYTES
        bnd = bound(nbytes, (25 if g2 else 9) * n * pts)
        res = {name: {"max_abs_err": 0}}
        time_cases({name: (what, lambda: flat(chain_call(wrap, spec, b3, P, n, steps)),
                           lambda: flat(chain_call(ref, spec, b3, P, n, steps)), reps, 1,
                           bnd)}, res)
        r = dict(res[name], points=pts, n=n, steps=steps, per_double_ms=res[name]["ms"] / n)
        out[f"{name} {pts} x {n}{' steps' if steps else ''}"] = r
        log(f"# chain {name} [{what}]: {r['per_double_ms']:.5f} ms a double")
        if results is not None:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], r["max_abs_err"])
            if (pts, n) == (1, 16):
                results[name].update({k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")})
    log(f"# chains {json.dumps(out)}")
    return out


def phase_g2_msm(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst

    n = 1 << LOG_N
    rng = random.Random(SEED + 5)
    ms = [rng.randrange(1, bn254.R) for _ in range(n)]
    ks = [rng.randrange(0, bn254.R) for _ in range(n)]
    ks[0], ks[1], ks[2], ks[3] = 0, 5, 5, bn254.R - 1  # zero and duplicates
    rspec = bn254.r_spec()
    m_limbs = msm.scalars_from_int(rspec, ms, dev)
    k_limbs = msm.scalars_from_int(rspec, ks, dev)
    F, b3 = bn254.g2_ops(), bn254.g2_b3((), dev)
    exp = bn254.g2_generator() * (sum(k * m for k, m in zip(ks, ms)) % bn254.R)
    table = ("loaded from its .npz cache" if fixed_base.table_path("g2").exists()
             else "built on the host first")
    t0 = time.perf_counter()
    pts, fb_counts = counted(lambda: fixed_base.fixed_base_multi("g2", m_limbs))
    fb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, counts = counted(lambda: msm.msm(F, b3, pts, k_limbs))
    first_s = time.perf_counter() - t0
    got = bn254.g2_points_to_host(wst.point_map(lambda c: c[:, None], res))[0]
    if got != exp:
        raise AssertionError("G2 MSM 2^20: result differs from the host golden")
    need = ("padd2", "pdbl2", "bucket_scan_rows2", "padd2_seg_level", "gather_planes",
            "scatter_rows")
    if min(counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"G2 MSM: a kernel of {need} never launched: {counts}")
    med, ts = median_ms(lambda: msm.msm(F, b3, pts, k_limbs))
    results["_g2_msm"] = {"ms": med, "reps_ms": ts, "points_per_s": n / med * 1e3,
                          "first_s": first_s, "fixed_base_s": fb_s,
                          "launches": counts, "fixed_base_launches": fb_counts}
    log(f"# g2 fixed-base 2^{LOG_N}: {fb_s:.3f} s (table {table}); launches "
        f"{json.dumps(fb_counts)}")
    log(f"# g2 msm 2^{LOG_N} (c = {msm.default_window(n)}): == host "
        f"[sum k_i m_i mod r]G2; first run {first_s:.3f} s; launches "
        f"{json.dumps(counts)}; median {med:.2f} ms of {[round(t, 2) for t in ts]}")
    time_scan(F, b3, pts, dev, results)


K1_PROVE_LAUNCHES = 100  # K1 + its chain in a prove at 2^20 (818 / 828 before)


def fresh_tables(fn):
    """fn() with the fixed-base row tables made anew, as a setup in a fresh
    process makes them (K16; the host tables stay loaded)."""
    from myzkp_tpu_torch.curves import fixed_base

    fixed_base._table_rows.cache_clear()
    return fn()


def check_setup_launches(name: str, counts: dict) -> None:
    need = ("gather_planes", "scatter_rows", "padd", "padd2")
    if min(counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"{name} setup: a kernel of {need} never launched: {counts}")


def check_k1_launches(name: str, counts: dict) -> None:
    k1, chain = counts.get("mont_mul", 0), counts.get("mont_pow", 0)
    log(f"# {name} prove: K1 {k1} launches, its chain mont_pow {chain}: {k1 + chain} in all")
    if chain < 1 or k1 + chain > K1_PROVE_LAUNCHES:
        raise AssertionError(f"{name} prove: K1 {k1} + mont_pow {chain} launches, expected "
                             f"the chain at least once and at most {K1_PROVE_LAUNCHES} in all")


def _square_chain_case(spec, m: int, dev):
    from myzkp_tpu_torch.arith import sparse

    r1cs, asg = sparse.square_chain(spec, m, device=dev)
    return sparse.SparseQAP(r1cs), asg


def _wrong_witness(asg, k: int):
    """The assignment with x_k changed: it no longer satisfies the circuit."""
    from myzkp_tpu_torch.fields.fp import Fp

    mont = asg.mont.clone()
    mont[:, k + 1] = Fp.from_int(asg.spec, 12345, asg.device).mont
    return Fp(asg.spec, mont)


def phase_pinocchio(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.snark import pinocchio as pin

    spec = bn254.r_spec()
    m = 1 << LOG_M_PIN
    t0 = time.perf_counter()
    qap, asg = _square_chain_case(spec, m, dev)
    bad_asg = _wrong_witness(asg, m // 2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (pk, vk), setup_counts = counted(lambda: fresh_tables(
        lambda: pin.setup(qap, random.Random(SEED))))
    setup_s = time.perf_counter() - t0
    check_setup_launches("pinocchio", setup_counts)
    t0 = time.perf_counter()
    proof, prove_counts = counted(lambda: pin.prove(asg, pk, qap, random.Random(SEED + 1)))
    first_s = time.perf_counter() - t0
    need = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "ntt_leaf", "padd2", "pdbl2",
            "bucket_scan_rows2", "padd_seg_level", "padd2_seg_level", "gather_planes",
            "scatter_rows")
    if min(prove_counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"prove 2^{LOG_M_PIN}: a kernel of {need} never launched: "
                             f"{prove_counts}")
    if prove_counts.get("butterfly", 0):
        raise AssertionError(f"prove 2^{LOG_M_PIN}: K5 launched (the four-step path has none)")
    t0 = time.perf_counter()
    ok = pin.verify(proof, vk)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"Pinocchio 2^{LOG_M_PIN}: verify rejected the proof")
    bad = pin.prove(bad_asg, pk, qap, random.Random(SEED + 1))
    if pin.verify(bad, vk):
        raise AssertionError(f"Pinocchio 2^{LOG_M_PIN}: verify accepted a wrong witness")
    med, ts = median_ms(lambda: pin.prove(asg, pk, qap, random.Random(SEED + 1)), reps=3)
    results["_pinocchio"] = {"setup_s": setup_s, "prove_ms": med, "prove_reps_ms": ts,
                             "prove_first_s": first_s, "verify_s": verify_s,
                             "circuit_s": build_s, "setup_launches": setup_counts,
                             "prove_launches": prove_counts}
    for k in ("padd2", "pdbl2", "bucket_scan_rows2", "padd2_seg_level"):
        results[k]["launches"] = prove_counts[k]
    # K5's pair form is on no prover's path: its count is read from this prove,
    # as K18's at L = 16 (fe_add, fe_sub)
    for k in [k for k, *_ in PAIR_WIDTHS] + ["fe_add", "fe_sub"]:
        results[k]["launches"] = prove_counts.get(k, 0)
    log(f"# pinocchio m = 2^{LOG_M_PIN}: circuit {build_s:.3f} s; setup {setup_s:.3f} s; "
        f"prove first {first_s:.3f} s, median {med:.2f} ms of {[round(t, 2) for t in ts]}; "
        f"verify {verify_s:.3f} s (host): accepted; a wrong witness (one x_k "
        f"changed): rejected")
    log(f"# pinocchio setup launches: {json.dumps(setup_counts)}")
    log(f"# pinocchio prove launches: {json.dumps(prove_counts)}")
    log(f"# pinocchio prove: K3 {prove_counts['pdbl']} launches, K8 "
        f"{prove_counts['pdbl2']}")
    check_k1_launches("pinocchio", prove_counts)

    # the whole path on the card against the plain versions on the CPU
    cpu = torch.device("cpu")
    ms = 1 << LOG_M_CMP
    proofs = []
    for d in (dev, cpu):
        t0 = time.perf_counter()
        q, a = _square_chain_case(spec, ms, d)
        pk_, vk_ = pin.setup(q, random.Random(SEED + 2))
        pr = pin.prove(a, pk_, q, random.Random(SEED + 3))
        if not pin.verify(pr, vk_):
            raise AssertionError(f"Pinocchio 2^{LOG_M_CMP} on {d}: verify rejected")
        proofs.append((pr, vk_, time.perf_counter() - t0))
    (card, card_vk, card_s), (plain, plain_vk, plain_s) = proofs
    if card != plain or card_vk != plain_vk:
        raise AssertionError(f"Pinocchio 2^{LOG_M_CMP}: the card's key or proof differs "
                             f"from the CPU plain versions'")
    log(f"# pinocchio m = 2^{LOG_M_CMP}: setup + prove on the card ({card_s:.2f} s) "
        f"and on the CPU plain versions ({plain_s:.2f} s), same seeds: verification "
        f"keys and proofs equal point for point; both accepted")


def time_g2_kernels(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    rng = np.random.default_rng(SEED + 6)
    spec = bn254.q_spec()
    b3 = bn254.g2_b3((), dev)
    m = SCAN_LANES
    coords = lambda: tuple((random_fe(rng, m, dev), random_fe(rng, m, dev))
                           for _ in range(3))
    P, Q = coords(), coords()
    # a segment head every 32 steps: heads are a few percent of the digits
    h = torch.arange(m, device=dev) % 32 == 0
    heads = int(h.sum())
    L = wst.leaves
    cases = {
        # an add reads 12 coordinates and writes 6 and needs 42 Montgomery
        # products, none on the lanes where h is set
        "padd2": (f"{m} lanes with h set on 1 in 32: one step of probe 13's loop",
                  lambda: L(ck.padd2(spec, b3, P, Q, h)),
                  lambda: L(ck.padd2_ref(spec, b3, P, Q, h)), 20, 1,
                  bound(18 * LIMB_BYTES * m + m + 2 * LIMB_BYTES, G2_ADD_PRODUCTS * (m - heads))),
    }
    time_cases(cases, results)
    design = bound(0, PAIR_G2_ADD_PRODUCTS * (m - heads))["bound_ms"]
    log(f"# padd2: the lane pair does {PAIR_G2_ADD_PRODUCTS} Montgomery products an add "
        f"where the function needs {G2_ADD_PRODUCTS}; at the integer multiply rate its "
        f"own products take {design:.4f} ms (bound {results['padd2']['bound_ms']:.4f})")
    # K2 at the same shape: 32,768 lanes is also the width of the first tree
    # level of the weighted bucket sum (G * 256 * 64)
    P1 = tuple(random_fe(rng, m, dev) for _ in range(3))
    Q1 = tuple(random_fe(rng, m, dev) for _ in range(3))
    b31 = bn254.g1_b3((), dev)
    lanes = {"padd": {"max_abs_err": 0}}
    time_cases({"padd": (f"{m} lanes with h set on 1 in 32",
                         lambda: ck.padd(spec, b31, P1, Q1, h),
                         lambda: ck.padd_ref(spec, b31, P1, Q1, h), 50, 1,
                         bound(9 * LIMB_BYTES * m + m + LIMB_BYTES, 14 * (m - heads)))},
               lanes)
    results["_padd_lanes"] = lanes["padd"]
    results["padd"]["max_abs_err"] = max(results["padd"]["max_abs_err"],
                                         lanes["padd"]["max_abs_err"])


def mixed_add_inputs(group: str, m: int, dev, seed: int):
    """P (projective) and Q = (qx, qy) (affine) over m lanes, for K9 (G1) or
    K10 (G2).  Q is one of 64 host points (never O: the affine form cannot
    express it); P a rescaling by a random lam of one of them or of O.  Lane
    kinds: P = O, P = Q (a doubling through the mixed formula, lam != 1), P =
    -Q (the sum is O), generic; the first m / 8 lanes hold 0, 1, q - 1 or
    R mod q in every coordinate component (not points).  Returns (F, b3, P,
    qx, qy, E, want) with want(lane) the host sum of a lane at or after E."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb

    g2 = group == "g2"
    rng = np.random.default_rng(seed)
    hrng = random.Random(seed)
    spec = bn254.q_spec()
    F, b3 = ((bn254.g2_ops(), bn254.g2_b3((), dev)) if g2
             else (bn254.g1_ops(), bn254.g1_b3((), dev)))
    gen = bn254.g2_generator() if g2 else bn254.g1_generator()
    curve = bn254.curve_g2 if g2 else bn254.curve_g1
    to_device = bn254.g2_points_to_device if g2 else bn254.g1_points_to_device
    host = [gen * hrng.randrange(1, bn254.R) for _ in range(64)]
    base = to_device(host + [curve.infinity()], dev)  # z = one: affine
    ia, ib, kinds = (rng.integers(0, n, m) for n in (64, 64, 8))
    ia = np.where((kinds == 0) | (kinds == 2), ib, ia)  # P = Q, P = -Q
    ia = np.where(kinds == 1, 64, ia)  # P = O
    ta, tb = (torch.from_numpy(i).to(dev) for i in (ia, ib))
    lam = ((random_fe(rng, m, dev), random_fe(rng, m, dev)) if g2
           else random_fe(rng, m, dev))
    (lam[0] if g2 else lam)[0] |= 1  # nonzero
    P = [F.mul(c, lam) for c in wst.point_map(lambda c: c[:, ta], base)]
    P[1] = F.select(torch.from_numpy(kinds == 2).to(dev), F.neg(P[1]), P[1])
    qx, qy = (wst.point_map(lambda c: c[:, tb], base)[k] for k in (0, 1))
    E = m // 8
    edges = [0, 1, spec.p - 1, (1 << 256) % spec.p]
    coords = [[t.clone() for t in (e if g2 else (e,))] for e in (*P, qx, qy)]
    for comps in coords:
        for t in comps:
            t[:, :E] = limb.from_int(spec, [edges[i] for i in rng.integers(0, 4, E)], dev)
    elems = [tuple(c) if g2 else c[0] for c in coords]

    def want(k):
        pk = curve.infinity() if ia[k] == 64 else host[ia[k]]
        return (-pk if kinds[k] == 2 else pk) + host[ib[k]]

    return F, b3, wst.Point(*elems[:3]), elems[3], elems[4], E, want


def phase_mixed_add(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254, curve_kernels as ck
    from myzkp_tpu_torch.curves import weierstrass as wst

    spec = bn254.q_spec()
    m = SCAN_LANES
    inputs = {g: mixed_add_inputs(g, m, dev, SEED + 7 + k) for k, g in enumerate(("g1", "g2"))}
    # a segment head every 32 steps, as in a bucket scan
    h = torch.arange(m, device=dev) % 32 == 0
    F1, b31, P1, qx1, qy1, E1, want1 = inputs["g1"]
    reps = MIX_WIDE // m
    wide = lambda e: e.repeat(1, reps)
    Pw = wst.point_map(wide, P1)
    qxw, qyw = wide(qx1), wide(qy1)
    F2, b32, P2, qx2, qy2, E2, want2 = inputs["g2"]

    def main_path():
        return {"g1_sel": wst.padd_mixed_sel(F1, b31, P1, qx1, qy1, h),
                "g1": wst.padd_mixed(F1, b31, P1, qx1, qy1),
                "g1_wide": wst.padd_mixed(F1, b31, Pw, qxw, qyw),
                "g2_sel": wst.padd_mixed_sel(F2, b32, P2, qx2, qy2, h),
                "g2": wst.padd_mixed(F2, b32, P2, qx2, qy2)}

    out, counts = counted(main_path)
    if min(counts.get(k, 0) for k in ("padd_mixed", "padd_mixed2")) < 1:
        raise AssertionError(f"mixed add: K9 or K10 never launched: {counts}")
    L = wst.leaves
    plain = {"g1_sel": ck.padd_mixed_ref(spec, b31, P1, qx1, qy1, h),
             "g1": ck.padd_mixed_ref(spec, b31, P1, qx1, qy1),
             "g1_wide": ck.padd_mixed_ref(spec, b31, Pw, qxw, qyw),
             "g2_sel": ck.padd_mixed2_ref(spec, b32, P2, qx2, qy2, h),
             "g2": ck.padd_mixed2_ref(spec, b32, P2, qx2, qy2)}
    err = {"padd_mixed": 0, "padd_mixed2": 0}
    for k, got in out.items():
        name = "padd_mixed2" if k.startswith("g2") else "padd_mixed"
        err[name] = max(err[name], check_equal(f"{name} [{k}]", L(got), L(wst.Point(*plain[k]))))
    del Pw, qxw, qyw, plain
    # the complete add of P and (qx, qy, one), with and without the mask
    for k, F, b3, P, qx, qy in (("g1", F1, b31, P1, qx1, qy1), ("g2", F2, b32, P2, qx2, qy2)):
        Q = wst.from_affine(F, qx, qy)
        full = wst.padd(F, b3, P, Q), wst.padd_sel(F, b3, P, Q, h)
        for got, w in zip((out[k], out[f"{k}_sel"]), full):
            if not all(torch.equal(a, b) for a, b in zip(L(got), L(w))):
                raise AssertionError(f"mixed add {k}: differs from the complete add of "
                                     f"(qx, qy, one)")
    # the host group law on 64 lanes past the edge lanes; P = -Q gives O
    for k, to_host, E, want in (("g1", bn254.g1_points_to_host, E1, want1),
                                ("g2", bn254.g2_points_to_host, E2, want2)):
        got = to_host(wst.point_map(lambda c: c[:, E:E + 64], out[k]))
        if got != [want(j) for j in range(E, E + 64)]:
            raise AssertionError(f"mixed add {k}: disagrees with the host group law")
    # K9 at a ragged width (not a multiple of a block, a warp or a lane group)
    nt = m - 5
    Pr = wst.point_map(lambda c: c[:, :nt].contiguous(), P1)
    qxr, qyr, hr = qx1[:, :nt].contiguous(), qy1[:, :nt].contiguous(), h[:nt].contiguous()
    for hh in (None, hr):
        err["padd_mixed"] = max(err["padd_mixed"], check_equal(
            f"padd_mixed [{nt} lanes{', h' if hh is not None else ''}]",
            list(ck.padd_mixed(spec, b31, Pr, qxr, qyr, hh)),
            list(ck.padd_mixed_ref(spec, b31, Pr, qxr, qyr, hh))))
    for k in ("padd_mixed", "padd_mixed2"):
        results[k] = {"max_abs_err": err[k], "launches": counts[k]}
    log(f"# mixed add: K9 at {m} and {nt} lanes (with and without h) and {MIX_WIDE} points, "
        f"K10 at {m} lanes (with and without h), through weierstrass.padd_mixed(_sel); "
        f"P = O, P = lam Q, P = -Q, and {E1} / {E2} lanes of 0, 1, q-1, R mod q in every "
        f"c0 and c1: exact vs plain and vs the complete add K2 / K7 of (qx, qy, one); "
        f"64 lanes per group match the host; launches {json.dumps(counts)}")

    # timing: K9 at K2's shape, K10 at K7's, and K9 with the mask at probe
    # 12's width (tools/scratch_prof4.py:84); a mixed add reads 5 coordinates
    # and writes 3 (G2: 10 and 6); 13 products (G2: 39), none where h is set
    rng = np.random.default_rng(SEED + 9)
    fe = lambda n: random_fe(rng, n, dev)
    Pt = tuple(fe(MIX_WIDE) for _ in range(3))
    qxt, qyt = fe(MIX_WIDE), fe(MIX_WIDE)
    P2t = tuple((fe(m), fe(m)) for _ in range(3))
    q2t = tuple((fe(m), fe(m)) for _ in range(2))
    heads = int(h.sum())
    probe = {"padd_mixed": {"max_abs_err": 0}}
    time_cases({"padd_mixed": (
        f"{m} lanes with h set on 1 in 32: probe 12's width",
        lambda: ck.padd_mixed(spec, b31, P1, qx1, qy1, h),
        lambda: ck.padd_mixed_ref(spec, b31, P1, qx1, qy1, h), 100, 3,
        bound(8 * LIMB_BYTES * m + m + LIMB_BYTES, 13 * (m - heads)))}, probe)
    time_cases({
        "padd_mixed": (f"{MIX_WIDE} points: a fixed-base tree level's width",
                       lambda: ck.padd_mixed(spec, b31, Pt, qxt, qyt),
                       lambda: ck.padd_mixed_ref(spec, b31, Pt, qxt, qyt), 5, 1,
                       bound(8 * LIMB_BYTES * MIX_WIDE + LIMB_BYTES, 13 * MIX_WIDE)),
        "padd_mixed2": (f"{m} lanes with h set on 1 in 32",
                        lambda: L(wst.Point(*ck.padd_mixed2(spec, b32, P2t, *q2t, h))),
                        lambda: L(wst.Point(*ck.padd_mixed2_ref(spec, b32, P2t, *q2t, h))),
                        20, 1,
                        bound(16 * LIMB_BYTES * m + m + 2 * LIMB_BYTES, 39 * (m - heads))),
    }, results)
    # K2 on the same inputs as K9's timed call, with (qx, qy, one) for Q
    Qt = (qxt, qyt, F1.one((MIX_WIDE,), dev).contiguous())
    k2_ms = graph_time_ms(lambda: ck.padd(spec, b31, Pt, Qt), 5)
    log(f"# time padd [{MIX_WIDE} points, the same P and Q = (qx, qy, one) as "
        f"padd_mixed's]: kernel {k2_ms:.4f} ms")
    del Pt, qxt, qyt, Qt
    # K7 on the same inputs as K10's timed call, with the mask, Q = (qx, qy, one)
    one2 = tuple(c.contiguous() for c in F2.one((m,), dev))
    k7_ms = graph_time_ms(lambda: ck.padd2(spec, b32, P2t, (*q2t, one2), h), 20)
    log(f"# time padd2 [{m} lanes, the same P, Q = (qx, qy, one) and h as padd_mixed2's]: "
        f"kernel {k7_ms:.4f} ms")
    # K10 at 2^20 lanes, no mask
    wide2 = {"padd_mixed2": {"max_abs_err": 0}}
    nw = 1 << LOG_N
    P2w = tuple((fe(nw), fe(nw)) for _ in range(3))
    q2w = tuple((fe(nw), fe(nw)) for _ in range(2))
    time_cases({"padd_mixed2": (
        f"{nw} lanes, no mask",
        lambda: L(wst.Point(*ck.padd_mixed2(spec, b32, P2w, *q2w))),
        lambda: L(wst.Point(*ck.padd_mixed2_ref(spec, b32, P2w, *q2w))), 5, 1,
        bound(16 * LIMB_BYTES * nw + 2 * LIMB_BYTES, 39 * nw))}, wide2)
    results["_mixed_add"] = {"probe12": probe["padd_mixed"], "launches": counts,
                             "padd_same_inputs_ms": k2_ms, "padd2_same_inputs_ms": k7_ms,
                             "padd_mixed2_2^20": wide2["padd_mixed2"]}


def _key_points(pk, vk) -> dict:
    """A Groth16 key on the host: every point batch (the proving key's and
    g1_k_pub) as a list of affine points, every other field as it is."""
    from myzkp_tpu_torch.curves import bn254

    out = {}
    for name, key in (("pk", pk), ("vk", vk)):
        for f, v in vars(key).items():
            if isinstance(v, tuple):  # a device point batch
                v = (bn254.g2_points_to_host if f.startswith("g2")
                     else bn254.g1_points_to_host)(v)
            out[f"{name}.{f}"] = v
    return out


def phase_groth16(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.snark import groth16 as g16

    spec = bn254.r_spec()
    m, npub = 1 << LOG_M_G16, NPUB_G16
    t0 = time.perf_counter()
    qap, asg = _square_chain_case(spec, m, dev)
    bad_asg = _wrong_witness(asg, m // 2)
    public = [int(v) for v in asg[:npub].to_int()]
    wrong_public = public[:-1] + [(public[-1] + 1) % bn254.R]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (pk, vk), setup_counts = counted(lambda: fresh_tables(
        lambda: g16.setup(qap, npub, random.Random(SEED))))
    setup_s = time.perf_counter() - t0
    check_setup_launches("groth16", setup_counts)
    t0 = time.perf_counter()
    proof, prove_counts = counted(lambda: g16.prove(asg, pk, qap, random.Random(SEED + 1)))
    first_s = time.perf_counter() - t0
    need = ("mont_mul", "padd", "pdbl", "bucket_scan_rows", "ntt_leaf", "padd2", "pdbl2",
            "bucket_scan_rows2", "padd_seg_level", "padd2_seg_level", "gather_planes",
            "scatter_rows")
    if min(prove_counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"groth16 prove 2^{LOG_M_G16}: a kernel of {need} never "
                             f"launched: {prove_counts}")
    t0 = time.perf_counter()
    ok = g16.verify(proof, vk, public)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: verify rejected the proof")
    if g16.verify(proof, vk, wrong_public):
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: verify accepted a wrong public input")
    bad = g16.prove(bad_asg, pk, qap, random.Random(SEED + 1))
    if g16.verify(bad, vk, public):
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: verify accepted a wrong witness")
    med, ts = median_ms(lambda: g16.prove(asg, pk, qap, random.Random(SEED + 1)), reps=3)
    results["_groth16"] = {"setup_s": setup_s, "prove_ms": med, "prove_reps_ms": ts,
                           "prove_first_s": first_s, "verify_s": verify_s,
                           "circuit_s": build_s, "setup_launches": setup_counts,
                           "prove_launches": prove_counts}
    for k in ("gather_planes", "scatter_rows"):
        results[k]["launches"] = prove_counts[k]
    if prove_counts.get("butterfly", 0):
        raise AssertionError(f"Groth16 2^{LOG_M_G16}: K5 launched (the four-step path has none)")
    log(f"# groth16 m = 2^{LOG_M_G16}, {npub} public inputs: circuit {build_s:.3f} s; "
        f"setup {setup_s:.3f} s; prove first {first_s:.3f} s, median {med:.2f} ms of "
        f"{[round(t, 2) for t in ts]}; verify {verify_s:.3f} s (host pairing): accepted; "
        f"a wrong public input: rejected; a wrong witness (one x_k changed): rejected")
    log(f"# groth16 setup launches: {json.dumps(setup_counts)}")
    log(f"# groth16 prove launches: {json.dumps(prove_counts)}")
    log(f"# groth16 prove: K3 {prove_counts['pdbl']} launches, K8 "
        f"{prove_counts['pdbl2']}")
    check_k1_launches("groth16", prove_counts)
    del pk, vk, qap, asg, bad_asg

    # the whole path on the card against the plain versions on the CPU
    cpu = torch.device("cpu")
    ms = 1 << LOG_M_CMP
    runs = []
    for d in (dev, cpu):
        t0 = time.perf_counter()
        q, a = _square_chain_case(spec, ms, d)
        pk_, vk_ = g16.setup(q, npub, random.Random(SEED + 2))
        pr = g16.prove(a, pk_, q, random.Random(SEED + 3))
        pub = [int(v) for v in a[:npub].to_int()]
        if not g16.verify(pr, vk_, pub):
            raise AssertionError(f"Groth16 2^{LOG_M_CMP} on {d}: verify rejected")
        runs.append((pr, _key_points(pk_, vk_), time.perf_counter() - t0))
    (card, card_keys, card_s), (plain, plain_keys, plain_s) = runs
    if card != plain or card_keys != plain_keys:
        raise AssertionError(f"Groth16 2^{LOG_M_CMP}: the card's keys or proof differ "
                             f"from the CPU plain versions'")
    log(f"# groth16 m = 2^{LOG_M_CMP}: setup + prove on the card ({card_s:.2f} s) and "
        f"on the CPU plain versions ({plain_s:.2f} s), same seeds: proving and "
        f"verifying keys and proofs equal point for point; both accepted")


# Phase 11: KZG and Gemini at 2^20 coefficients (commit/kzg.py, commit/gemini.py).
# The SRS has degree 2^20: Gemini's first fold carries a degree bound of its
# 2^20 coefficients, which needs the power s^(2^20).
LOG_KZG = 20
KZG_SMALL = 15  # KZG and Gemini on the card and on the CPU: the JAX tests' degree
K1_OPEN_LAUNCHES = 1000  # K1 + its chain in one open at 2^20 (a loop a coefficient: ~2^20)
# The kernels of the KZG / Gemini path (the MSMs, the G2 setup tree and the
# ladder of commit_g2) and of fast_multiply (K5 below 2^14 points, K6 above)
KZG_KERNELS = MSM_KERNELS + ("padd2", "pdbl2")
FAST_MUL_LOGS = ((19, "ntt_leaf"), (8, "butterfly"))


def lagrange_at(xs, ys, x: int, p: int) -> int:
    """I(x) for the interpolant of the host points (xs, ys)."""
    total = 0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = den = 1
        for j, xj in enumerate(xs):
            if j != i:
                num, den = num * (x - xj) % p, den * (xi - xj) % p
        total = (total + yi * num * pow(den, -1, p)) % p
    return total


def host_folds(coeffs, rhos, p: int) -> list:
    """Gemini's folds f_i = even(f_(i-1)) + rho_i odd(f_(i-1)) on host ints."""
    fs = [coeffs]
    for rho in rhos:
        f = fs[-1]
        fs.append([(e + rho * o) % p for e, o in zip(f[0::2], f[1::2])])
    return fs


def kzg_small(d, s: int) -> tuple:
    """KZG and Gemini at degree KZG_SMALL on device d from one seed: the
    commitment, the opening, the batch opening, the degree proof, Gemini's
    commitments and proof (host points and ints), and the key."""
    from myzkp_tpu_torch.commit import gemini, kzg
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.ops.poly import Poly

    spec, R = bn254.r_spec(), bn254.R
    rng = random.Random(SEED + 21)
    pk = kzg.setup(KZG_SMALL, s=s, full_g2=True, device=d)
    p = Poly.from_int_coeffs(spec, [rng.randrange(R) for _ in range(8)], d)
    mcoefs, rhos = [rng.randrange(R) for _ in range(4)], [rng.randrange(R) for _ in range(2)]
    beta = rng.randrange(R)
    fs = gemini.split_and_fold(Fp.from_int(spec, mcoefs, d), rhos)
    pi = gemini.open_gemini(fs, beta, pk)
    out = [kzg.commit(pk, p), kzg.open(pk, p, 123), kzg.batch_open(pk, p, [2, 5, 9]),
           kzg.prove_degree_bound(pk, p, 8), gemini.commit_gemini(fs, pk), pi.es,
           pi.degree_proofs]
    return out, pk, (rhos, int(fs[-1].to_int()[0]), beta)


def phase_kzg(dev, results: dict) -> tuple:
    from myzkp_tpu_torch.commit import gemini, kzg
    from myzkp_tpu_torch.curves import bn254, weierstrass as wst
    from myzkp_tpu_torch.curves.msm import scalars_from_int
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.ops.poly import Poly

    t_phase = time.perf_counter()
    spec, R = bn254.r_spec(), bn254.R
    G1, G2 = bn254.g1_generator(), bn254.g2_generator()
    n = 1 << LOG_KZG
    rng = random.Random(SEED + 20)
    s = rng.randrange(1, R)
    counts, secs = {}, {}

    run = functools.partial(run_counted, counts, secs)

    # setup: the host powers of s and their limbs, then the whole setup
    _, secs["setup_host"] = timed(lambda: scalars_from_int(spec, kzg._powers_of_s(s, n + 1), dev))
    pk = run("setup", lambda: fresh_tables(lambda: kzg.setup(n, s=s, full_g2=True)))
    idx = sorted({0, 1, n} | set(rng.sample(range(n + 1), 5)))
    sample = lambda pt: wst.point_map(lambda a: a[:, idx], pt)
    if (bn254.g1_points_to_host(sample(pk.powers1)) != [G1 * pow(s, i, R) for i in idx]
            or bn254.g2_points_to_host(sample(pk.powers2)) != [G2 * pow(s, i, R) for i in idx]):
        raise AssertionError(f"KZG setup 2^{LOG_KZG}: [s^i]G1 or [s^i]G2 differs from the "
                             f"host at i in {idx}")

    # commit, open, batch open
    coeffs = [rng.randrange(R) for _ in range(n)]
    p = Poly.from_int_coeffs(spec, coeffs, dev)
    ps = horner(coeffs, s, R)
    C = run("commit", lambda: kzg.commit(pk, p))
    if C != G1 * ps:
        raise AssertionError(f"KZG commit 2^{LOG_KZG}: C != [p(s)]G1")
    commit_ms, commit_reps = median_ms(lambda: kzg.commit(pk, p), reps=3)
    u = rng.randrange(R)
    y, w = run("open", lambda: kzg.open(pk, p, u))
    if y != horner(coeffs, u, R) or w != G1 * ((ps - y) * pow(s - u, -1, R) % R):
        raise AssertionError(f"KZG open 2^{LOG_KZG}: y or w differs from the host")
    k1_open = counts["open"].get("mont_mul", 0) + counts["open"].get("mont_pow", 0)
    if k1_open >= K1_OPEN_LAUNCHES:
        raise AssertionError(f"KZG open 2^{LOG_KZG}: {k1_open} K1 + chain launches, "
                             f"expected fewer than {K1_OPEN_LAUNCHES}")
    ok = run("verify", lambda: (kzg.verify(pk, u, y, C, w),
                                kzg.verify(pk, u, (y + 1) % R, C, w)))
    if ok != (True, False):
        raise AssertionError(f"KZG verify 2^{LOG_KZG}: (accept, y + 1) gave {ok}")
    us = [rng.randrange(R) for _ in range(3)]
    ys, wb = run("batch_open", lambda: kzg.batch_open(pk, p, us))
    z_s = (s - us[0]) * (s - us[1]) * (s - us[2]) % R
    if (ys != [horner(coeffs, x, R) for x in us]
            or wb != G1 * ((ps - lagrange_at(us, ys, s, R)) * pow(z_s, -1, R) % R)):
        raise AssertionError(f"KZG batch open 2^{LOG_KZG}: ys or w differs from the host")
    bad = [(ys[0] + 1) % R] + ys[1:]
    ok = run("batch_verify", lambda: (kzg.batch_verify(pk, us, ys, C, wb),
                                      kzg.batch_verify(pk, us, bad, C, wb)))
    if ok != (True, False):
        raise AssertionError(f"KZG batch verify 2^{LOG_KZG}: (accept, one y changed) gave {ok}")

    # the degree bound: d = 2^19 on a polynomial of degree 2^19
    d = n // 2
    p_d = Poly(p.coef[: d + 1])
    pd_s = horner(coeffs[: d + 1], s, R)
    C_d = kzg.commit(pk, p_d)
    dp = run("degree", lambda: kzg.prove_degree_bound(pk, p_d, d))
    if C_d != G1 * pd_s or dp != G1 * (pow(s, n - d, R) * pd_s % R):
        raise AssertionError(f"KZG degree bound 2^{LOG_KZG - 1}: C or proof differs from the host")
    ok = run("verify_degree", lambda: (kzg.verify_degree_bound(pk, C_d, dp, d),
                                       kzg.verify_degree_bound(pk, C_d, dp, d - 1)))
    if ok != (True, False):
        raise AssertionError(f"KZG degree bound: (d, d - 1) gave {ok}")

    # Gemini over the 2^20 coefficients: 20 folds, 21 polynomials
    rhos = [rng.randrange(R) for _ in range(LOG_KZG)]
    beta = rng.randrange(R)
    def fold_and_commit():
        fs = gemini.split_and_fold(p.coef, rhos)
        return fs, gemini.commit_gemini(fs, pk)

    fs, cg = run("gemini_commit", fold_and_commit)
    host = host_folds(coeffs, rhos, R)
    mu = host[-1][0]
    if int(fs[-1].to_int()[0]) != mu or cg != [G1 * horner(f, s, R) for f in host]:
        raise AssertionError(f"Gemini 2^{LOG_KZG}: a commitment differs from [f_i(s)]G1")
    pi = run("gemini_open", lambda: gemini.open_gemini(fs, beta, pk))
    # two whole verifies: each checks every degree bound and batch opening
    # and computes its own [Z(s)]G2 (the mu + 1 proof fails only at the end)
    ok = (run("gemini_verify", lambda: gemini.verify_gemini(rhos, mu, beta, cg, pi, pk)),
          run("gemini_reject", lambda: gemini.verify_gemini(rhos, (mu + 1) % R, beta, cg, pi, pk)))
    if ok != (True, False):
        raise AssertionError(f"Gemini 2^{LOG_KZG}: verify (accept, mu + 1) gave {ok}")
    del fs, pi, p, p_d

    # fast_multiply: K6 at 2^19 x 2^19, K5 at 2^8 x 2^8
    fm = {}
    for logm, kern in FAST_MUL_LOGS:
        a, b = ([rng.randrange(R) for _ in range(1 << logm)] for _ in range(2))
        fa, fb = Fp.from_int(spec, a, dev), Fp.from_int(spec, b, dev)
        prod = run(f"fast_multiply_2^{logm}", lambda: ntt.fast_multiply(fa, fb))
        if counts[f"fast_multiply_2^{logm}"].get(kern, 0) < 1:
            raise AssertionError(f"fast_multiply 2^{logm}: {kern} never launched")
        if kern == "butterfly" and counts[f"fast_multiply_2^{logm}"][kern] != k5_launches(
                FAST_MUL_TRANSFORMS):
            raise AssertionError(f"fast_multiply 2^{logm}: {counts[f'fast_multiply_2^{logm}']} "
                                 f"K5 launches, not {k5_launches(FAST_MUL_TRANSFORMS)}")
        pv = [int(v) for v in prod.to_int()]
        xs = [rng.randrange(R) for _ in range(3)]
        if [horner(pv, x, R) for x in xs] != [horner(a, x, R) * horner(b, x, R) % R for x in xs]:
            raise AssertionError(f"fast_multiply 2^{logm}: p(x) q(x) differs from the host")
        fm[f"2^{logm}"] = median_ms(lambda: ntt.fast_multiply(fa, fb), reps=3)[0]

    # degree KZG_SMALL on the card and on the CPU plain versions, same s
    (card_out, pk_c, (rh, mu_c, be)), card_s = timed(lambda: kzg_small(dev, s))
    (plain_out, _, _), plain_s = timed(lambda: kzg_small(torch.device("cpu"), s))
    if card_out != plain_out:
        raise AssertionError(f"KZG / Gemini degree {KZG_SMALL}: the card's commitments or "
                             f"proofs differ from the CPU plain versions'")
    C_c, (y_c, w_c), (ys_c, wb_c), dp_c, cg_c, es_c, dps_c = card_out
    ok = (kzg.verify(pk_c, 123, y_c, C_c, w_c), kzg.batch_verify(pk_c, [2, 5, 9], ys_c, C_c, wb_c),
          kzg.verify_degree_bound(pk_c, C_c, dp_c, 8),
          gemini.verify_gemini(rh, mu_c, be, cg_c, gemini.ProofGemini(es_c, dps_c), pk_c))
    if not all(ok):
        raise AssertionError(f"KZG / Gemini degree {KZG_SMALL} on the card: a verifier "
                             f"rejected: {ok}")

    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    need = KZG_KERNELS + tuple(k for _, k in FAST_MUL_LOGS)
    if min(total.get(k, 0) for k in need) < 1:
        raise AssertionError(f"KZG phase: a kernel of {need} never launched: {total}")
    if min(counts["commit"].get(k, 0) for k in MSM_KERNELS) < 1:
        raise AssertionError(f"KZG commit: a kernel of {MSM_KERNELS} never launched: "
                             f"{counts['commit']}")
    for k in results:
        if not k.startswith("_"):
            results[k]["kzg_launches"] = total.get(k, 0)
    secs["phase"] = time.perf_counter() - t_phase
    results["_kzg"] = {"card": card(), "seconds": secs, "commit_ms": commit_ms,
                       "commit_reps_ms": commit_reps, "fast_multiply_ms": fm,
                       "small_card_s": card_s, "small_plain_s": plain_s, "launches": counts}
    smi = card()
    log(f"# kzg 2^{LOG_KZG} ({smi}): setup of degree 2^{LOG_KZG}, full G2, "
        f"{secs['setup']:.3f} s (host powers and limbs {secs['setup_host']:.3f} s), "
        f"[s^i]G1, G2 == host at i in {idx}; commit == [p(s)]G1, median {commit_ms:.2f} ms of "
        f"{[round(t, 2) for t in commit_reps]}; open {secs['open']:.3f} s, y and w == host, "
        f"verify {secs['verify']:.3f} s (2 calls, pairings on the host): accepted, y + 1 rejected; "
        f"batch open at 3 points {secs['batch_open']:.3f} s, ys and w == host, batch verify "
        f"{secs['batch_verify']:.3f} s (2 calls): accepted, one y changed rejected; degree "
        f"bound d = 2^{LOG_KZG - 1} {secs['degree']:.3f} s == host: verify (2 calls) "
        f"{secs['verify_degree']:.3f} s, true at d, false at d - 1")
    log(f"# gemini 2^{LOG_KZG} ({smi}): fold + commit of 21 polynomials "
        f"{secs['gemini_commit']:.3f} s, each == [f_i(s)]G1; open {secs['gemini_open']:.3f} s; "
        f"verify {secs['gemini_verify']:.3f} s: accepted; the same proof with mu + 1 "
        f"{secs['gemini_reject']:.3f} s: rejected")
    sizes = " and ".join(f"2^{m} x 2^{m} ({k})" for m, k in FAST_MUL_LOGS)
    log(f"# fast_multiply ({smi}): {sizes} == host p(x) q(x) at 3 points; median ms "
        f"{json.dumps(fm)}")
    log(f"# kzg degree {KZG_SMALL}: on the card ({card_s:.2f} s) and on the CPU plain "
        f"versions ({plain_s:.2f} s), same s: commitments, openings, degree proof and "
        f"Gemini's commitments and proof equal point for point; the card's verified")
    for name in ("commit", "open", "batch_open", "degree", "gemini_commit", "gemini_open"):
        log(f"# kzg {name} launches: {json.dumps(counts[name])}")
    log(f"# kzg open: K1 {counts['open'].get('mont_mul', 0)} launches, its chain "
        f"{counts['open'].get('mont_pow', 0)}: {k1_open} in all (under {K1_OPEN_LAUNCHES})")
    log(f"# kzg phase {secs['phase']:.1f} s")
    return pk, s


# Phase 12: both sumcheck provers (protocols/sumcheck_tpu.py, protocols/sumcheck.py)
# at the width of the port's other paths: a 2^20-point hypercube, and the
# Gemini-tied sumcheck at el = 20 (Gemini over 2^20 coefficients) on phase 11's
# SRS.  The table prover's problem is the demo's (examples/sumcheck_demo.py:
# three multilinear factors of 8 terms from random.Random(45), degree 3).
LOG_SC = 20
LOG_SC_HOST = 12  # the table prover against the port's host mirror
SC_FACTORS, SC_TERMS, SC_SEED = 3, 8, 45
K1_SUMCHECK_LAUNCHES = 2000  # K1 + its chain in a table prove (a loop an element: ~2^20)


def demo_factors(spec, num_vars: int) -> list:
    """The demo's factors (``protocols/sumcheck_cli.py``): SC_FACTORS random
    multilinear MPolys of SC_TERMS terms from random.Random(SC_SEED)."""
    from myzkp_tpu_torch.protocols import sumcheck_cli

    return sumcheck_cli.demo_factors(spec, num_vars, random.Random(SC_SEED))


class split_timer:
    """Within the block, each call of owner.name also adds its seconds (host
    clock, ended by a synchronize) to ``self.secs``; callers reach the
    function through its owner, so they see the wrapper."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.secs = owner, name, 0.0

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def wrapped(*a, **k):
            out, sec = timed(lambda: fn(*a, **k))
            self.secs += sec
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def phase_sumcheck(dev, results: dict, pk, s: int) -> None:
    from myzkp_tpu_torch.commit import gemini
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.ops.mpoly import MPoly
    from myzkp_tpu_torch.protocols import sumcheck as sc
    from myzkp_tpu_torch.protocols import sumcheck_tpu as st

    t_phase = time.perf_counter()
    spec, R = bn254.r_spec(), bn254.R
    G1 = bn254.g1_generator()
    counts, secs = {}, {}

    run = functools.partial(run_counted, counts, secs)

    def rejects(name: str, fn, what: str):
        if run(name, fn):
            raise AssertionError(f"sumcheck: the verifier accepted {what}")

    # (a) the table prover over the 2^20-point hypercube
    factors = demo_factors(spec, LOG_SC)
    prover, verifier = st.SumCheckProverTPU(spec, SC_FACTORS), st.SumCheckVerifier(spec)
    with split_timer(st, "eval_all_binary_combinations") as build:
        proof = run("table_prove", lambda: prover.prove(factors, LOG_SC))
    first = {"total_s": secs["table_prove"], "build_s": build.secs}
    k1 = counts["table_prove"].get("mont_mul", 0) + counts["table_prove"].get("mont_pow", 0)
    if k1 >= K1_SUMCHECK_LAUNCHES or counts["table_prove"].get("mont_mul", 0) < 1:
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC}: {k1} K1 + chain launches, "
                             f"expected 1 to {K1_SUMCHECK_LAUNCHES - 1}")
    if not run("table_verify", lambda: verifier.verify(proof, factors)):
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC}: the verifier rejected it")
    rejects("table_reject_sum", lambda: verifier.verify(st.ProductSumcheckProof(
        proof.el, (proof.claimed_sum + 1) % R, proof.round_polys), factors),
        "a changed claimed sum")
    rp = [list(c) for c in proof.round_polys]
    rp[LOG_SC // 2][2] = (rp[LOG_SC // 2][2] + 1) % R
    rejects("table_reject_round", lambda: verifier.verify(st.ProductSumcheckProof(
        proof.el, proof.claimed_sum, rp), factors), "a changed round coefficient")
    reps = []
    for _ in range(3):
        with split_timer(st, "eval_all_binary_combinations") as build:
            again, total = timed(lambda: prover.prove(factors, LOG_SC))
        if (again.claimed_sum, again.round_polys) != (proof.claimed_sum, proof.round_polys):
            raise AssertionError(f"sumcheck table prove 2^{LOG_SC}: a second prove differs")
        reps.append((total * 1e3, build.secs * 1e3))
    med = sorted(reps)[1]
    table = {"prove_ms": med[0], "build_ms": med[1], "rounds_ms": med[0] - med[1],
             "reps_ms": reps, "first": first, "k1_launches": k1}
    del factors, proof, again

    # (b) the same prover at 2^12 against the port's host mirror
    small = demo_factors(spec, LOG_SC_HOST)
    card_p, card_s = timed(lambda: prover.prove(small, LOG_SC_HOST))
    t0 = time.perf_counter()
    host_p = st.SumCheckProverHost(spec, SC_FACTORS).prove(small, LOG_SC_HOST)
    host_s = time.perf_counter() - t0
    if (card_p.claimed_sum, card_p.round_polys) != (host_p.claimed_sum, host_p.round_polys):
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC_HOST}: the card's claimed sum "
                             f"or round polynomials differ from the host mirror's")
    if not verifier.verify(card_p, small):
        raise AssertionError(f"sumcheck table prove 2^{LOG_SC_HOST}: the verifier rejected it")

    # (c) the Gemini-tied sumcheck at el = 20 on phase 11's SRS
    rng = random.Random(SEED + 30)
    d = {tuple(rng.randint(0, 1) for _ in range(LOG_SC)): rng.randrange(R)
         for _ in range(SC_TERMS)}
    d[(1,) * LOG_SC] = rng.randrange(1, R)  # g has all 20 variables
    g = MPoly(spec, d)
    h = run("hypercube_sum", lambda: sc.sum_over_boolean_hypercube(g, dev))
    if h != sum(c << (LOG_SC - sum(e)) for e, c in g.d.items()) % R:
        raise AssertionError(f"sumcheck 2^{LOG_SC}: the hypercube sum differs from the host's")
    with split_timer(sc, "commit_sumcheck") as commit, \
            split_timer(gemini, "open_gemini") as opening:
        sp = run("gemini_prove", lambda: sc.prove_sumcheck(g, h, pk))
    stream = sc._transcript(sp.el, sp.h)
    rs = [sc._round_challenge(spec, stream, g_j) for g_j in sp.gs]
    folds = host_folds(sc.get_coefs_in_order(g), rs, R)
    if sp.c_g != [G1 * horner(f, s, R) for f in folds]:
        raise AssertionError(f"sumcheck 2^{LOG_SC}: c_g differs from the host's [f_i(s)]G1")
    if not run("gemini_verify", lambda: sc.verify_sumcheck(sp, pk)):
        raise AssertionError(f"sumcheck 2^{LOG_SC}: verify_sumcheck rejected the proof")
    rejects("gemini_reject_h", lambda: sc.verify_sumcheck(
        sc.SumCheckProof(**{**sp.__dict__, "h": (h + 1) % R}), pk), "a changed h")
    gs = list(sp.gs)
    gs[LOG_SC // 2] = gs[LOG_SC // 2] + MPoly.constant(spec, 1)
    rejects("gemini_reject_gj", lambda: sc.verify_sumcheck(
        sc.SumCheckProof(**{**sp.__dict__, "gs": gs}), pk), "a changed g_j")
    gem = {"prove_s": secs["gemini_prove"], "commit_s": commit.secs, "open_s": opening.secs,
           "rounds_s": secs["gemini_prove"] - commit.secs - opening.secs}

    need = {"gemini_prove": MSM_KERNELS, "gemini_verify": ("padd", "pdbl", "padd2", "pdbl2")}
    for name, kernels in need.items():
        if min(counts[name].get(k, 0) for k in kernels) < 1:
            raise AssertionError(f"sumcheck {name}: a kernel of {kernels} never launched: "
                                 f"{counts[name]}")
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    for k in results:
        if not k.startswith("_"):
            results[k]["sumcheck_launches"] = total.get(k, 0)
    secs["phase"] = time.perf_counter() - t_phase
    results["_sumcheck"] = {"card": card(), "table": table, "small_card_s": card_s,
                            "small_host_s": host_s, "gemini": gem, "seconds": secs,
                            "launches": counts}
    smi = card()
    log(f"# sumcheck table 2^{LOG_SC} ({smi}): {SC_FACTORS} factors x {SC_TERMS} terms, "
        f"degree {SC_FACTORS}; prove median {med[0]:.2f} ms of "
        f"{[round(t, 2) for t, _ in reps]} (table build {med[1]:.2f}, rounds "
        f"{med[0] - med[1]:.2f}); first {first['total_s']:.3f} s (build "
        f"{first['build_s']:.3f}); verify {secs['table_verify']:.3f} s: accepted; a changed "
        f"claimed sum and a changed round coefficient rejected; K1 {k1} launches "
        f"(under {K1_SUMCHECK_LAUNCHES})")
    log(f"# sumcheck table 2^{LOG_SC_HOST}: the card's proof ({card_s:.3f} s) == the host "
        f"mirror's ({host_s:.3f} s): claimed sum and all {LOG_SC_HOST} round polynomials")
    log(f"# sumcheck gemini el = {LOG_SC} ({smi}): hypercube sum == host "
        f"({secs['hypercube_sum']:.3f} s); prove {gem['prove_s']:.3f} s (host rounds "
        f"{gem['rounds_s']:.3f}, commit {gem['commit_s']:.3f}, open {gem['open_s']:.3f}); "
        f"c_g == [f_i(s)]G1 of the host folds; verify {secs['gemini_verify']:.3f} s: "
        f"accepted; a changed h {secs['gemini_reject_h']:.3f} s and a changed g_j "
        f"{secs['gemini_reject_gj']:.3f} s: rejected")
    for name in ("table_prove", "gemini_prove", "gemini_verify"):
        log(f"# sumcheck {name} launches: {json.dumps(counts[name])}")
    log(f"# sumcheck phase {secs['phase']:.1f} s")


STARK_CYCLES = 65528  # the squaring AIR: 8 randomizers fill a 2^16-row trace
STARK_PARAMS = (4, 2, 2, 1, STARK_CYCLES, 2)  # initialize_fast_stark_m128's arguments
STARK_SEED = 7
STARK_X0 = 123456789
HASH_BATCH = 1 << 20
# K5's launches in a prove: at most two a Stockham transform (its 114:
# stockham_plan.cuh splits up to 2^10 points into one pass and 2^11 ... 2^13
# into two, 141 in all); a one-stage-a-launch K5 made 5,940
K5_STARK_LAUNCHES = 2 * 114
STARK_KERNELS = ("mont_mul_l8", "mont_pow_l8", "butterfly_l8", "ntt_leaf_l8",
                 "long_division_l8")
STARK_STAGES = (  # (owner module, attribute, stage): the prove's split
    ("fast_stark", "FastStark._interpolate_trace", "trace interpolation"),
    ("fast_stark", "FastStark._boundary_quotients", "boundary quotients"),
    ("fast_stark", "FastStark._commit_codeword", "codewords + Merkle"),
    ("fast_stark", "FastStark._transition_polys", "symbolic AIR"),
    ("fast_stark", "FastStark._coset_divide", "transition quotients"),
    ("fast_stark", "FastStark._combined_codeword", "combination"),
    ("fri", "FRI.prove", "FRI"),
    ("fast_stark", "FastStark._open", "openings"),
)
DIV_DIRECT = 512  # K17 held to its plain loop up to this many steps a row
# The (rows, na, bd) of K17's 17 launches in a FastStark prove over a
# 2^20-point FRI domain: the remainder tree of the trace interpolation
# (2^(16-k) rows of 2^(k+1) coefficients by nodes of degree 2^k, k = 15 ... 0)
# and the boundary quotient (65,536 coefficients by a quadratic)
STARK_DIV_SHAPES = tuple((1 << (16 - k), 1 << (k + 1), 1 << k)
                         for k in range(15, -1, -1)) + ((1, 1 << 16, 2),)
# K17 against its plain version across every edge of its launch plan
# (csrc/div_plan.cuh) on the H100: (rows, na, bd, what); b broadcast where
# rows are marked so, a zero leading coefficient on row 1 where marked
DIV_EDGE_SHAPES = (
    (3, 41, 1, "bd = 1, a thread a row"),
    (4, 16, 8, "bd = 8, 8 steps, a thread a row"),
    (2, 300, 1, "bd = 1, chunks, the last one partial"),
    (1, 1000, 2, "the boundary quotient's bd, chunks"),
    (2, 81, 8, "bd = 8, 73 steps: chunks"),
    (5, 72, 9, "bd = 9: blocks, B - 1 steps, a grid of 2 blocks a row"),
    (5, 73, 9, "B steps, bd < B"),
    (5, 74, 9, "B + 1 steps: a block of one"),
    (3, 171, 40, "2B + 3 steps"),
    (80, 60, 20, "one block a row (80 rows)"),
    (6, 200, 100, "na = 2 bd, a grid of 4, zero lead"),
    (4, 150, 70, "b broadcast, zero lead, a grid of 4"),
    (8, 1200, 600, "a grid of 16 blocks a row"),
    (1, 4200, 2100, "a grid of 64 blocks"),
    (3, 200000, 199950, "long rows, zero lead: at BN254 a grid of 64 blocks a row in two "
                        "launches (2 + 1 rows)"),
    (1, 1700000, 1699990, "a row past the blocks' shared memory: the window in global "
                          "scratch"),
)
DIV_EDGE_RANDOM = 4099  # random values of a long edge shape, tiled to its length


def random_fe4(rng: random.Random, n: int, dev, spec) -> torch.Tensor:
    """n random canonical M128 elements as (8, n) limbs (standard domain)."""
    from myzkp_tpu_torch.fields import limb

    return limb.from_int(spec, [rng.randrange(spec.p) for _ in range(n)], dev).contiguous()


def squaring_air(spec, cycles: int):
    """The JAX package's squaring AIR (tests/test_stark_e2e.py:50-75): one
    register, x_(i+1) = x_i^2; trace, AIR and boundary (first and last)."""
    from myzkp_tpu_torch.ops.mpoly import MPoly

    trace, x = [], STARK_X0
    for _ in range(cycles):
        trace.append([x])
        x = x * x % spec.p
    var = MPoly.variables(spec, 3)  # (cycle, prev, next)
    return trace, [var[1] ** 2 - var[2]], [(0, 0, STARK_X0), (cycles - 1, 0, trace[-1][0])]


def phase_bitcheck_m128(dev, results: dict) -> None:
    """K1, its chain at four words (M128) against their plain versions and
    the host: K1 on 2^20 pairs, every pair of the four-word edges first; the
    chain at 1, 2, 3, 16, 4,097 elements (edges among them) for e = 0, 1, 2,
    p - 2 and alpha^-1 (Rescue-Prime's inverse S-box)."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import m128_spec
    from myzkp_tpu_torch.stark import rescue_constants

    spec = m128_spec()
    p, R = spec.p, 1 << 128
    rng = random.Random(SEED + 128)
    edges = word_edges(p, 4)
    if edges[-4:] != [1 << 127, (1 << 127) + 1, (1 << 127) + (1 << 96) - 1, p - 2]:
        raise AssertionError("word_edges(M128, 4): the edges past R / 2 changed")
    k = len(edges) ** 2
    n = 1 << LOG_N
    a = random_fe4(rng, n, dev, spec)
    b = torch.roll(a, 12345, 1).contiguous()
    a[:, :k] = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    b[:, :k] = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    got = limb.mont_mul(spec, a, b)
    err = check_equal("mont_mul_l8", [got], [limb.mont_mul_ref(spec, a, b)])
    rinv = pow(R, -1, p)
    gi = limb.to_int(spec, got[:, :k])
    if any(int(g) != x * y * rinv % p
           for g, (x, y) in zip(gi, ((x, y) for x in edges for y in edges))):
        raise AssertionError("mont_mul_l8: disagrees with the host on the word edges")
    results["mont_mul_l8"]["max_abs_err"] = err
    log(f"# bitcheck mont_mul_l8 (M128): 2^{LOG_N} pairs, the first {k} every pair of "
        f"{len(edges)} word edges (each 32-bit word 0 or 0xFFFFFFFF below p; p - 1, 1, "
        f"R mod p; 2^127, 2^127 + 1, 2^127 + 2^96 - 1, p - 2): exact, and the edge pairs "
        f"== host")
    err = 0
    exps = (0, 1, 2, p - 2, rescue_constants.ALPHA_INV)
    for n in POW_SIZES:
        a = random_fe4(rng, n, dev, spec)
        a[:, :min(n, len(edges))] = limb.from_int(spec, edges[:n], dev)
        xs = [int(v) * rinv % p for v in limb.to_int(spec, a)]
        for e in exps:
            before = _ext.launches["mont_pow_l8"]
            got = limb.pow_const(spec, a, e)
            if _ext.launches["mont_pow_l8"] != before + 1:
                raise AssertionError("pow_const (M128): not one launch of the chain")
            err = max(err, check_equal(f"mont_pow_l8 n = {n} e = {e}", [got],
                                       [limb.mont_pow_ref(spec, a, e)]))
            if any(int(g) != pow(x, e, p) * R % p
                   for g, x in zip(limb.to_int(spec, got), xs)):
                raise AssertionError(f"mont_pow_l8 n = {n} e = {e}: differs from the host")
    results["mont_pow_l8"]["max_abs_err"] = max(results["mont_pow_l8"].get("max_abs_err", 0), err)
    log(f"# bitcheck mont_pow_l8 (M128): {POW_SIZES} elements (word edges among them), "
        f"e = 0, 1, 2, p - 2, alpha^-1, one launch each: exact vs plain and == host")


class recorder:
    """Within the block, each call of owner.name is also recorded: its
    arguments (tensors kept) under key(*args), the first call of each key
    only, and the calls of each key counted."""

    def __init__(self, owner, name: str, key):
        self.owner, self.name, self.key, self.calls, self.counts = owner, name, key, {}, {}

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def wrapped(*a, **k):
            key = self.key(*a, **k)
            self.calls.setdefault(key, (a, k))
            self.counts[key] = self.counts.get(key, 0) + 1
            return fn(*a, **k)

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def bitcheck_div_edges(dev, log_it: bool = True) -> int:
    """K17 at DIV_EDGE_SHAPES, both instances (M128, BN254's r), against
    long_division_ref bit for bit: the word edges lead a and b (past
    DIV_EDGE_RANDOM values the random ones repeat), marked rows broadcast b
    or zero its leading coefficient (q = 0, r = a's low bd).  With log_it
    the plans must cover every regime: a thread a row, chunks, blocks at G =
    1 and G >= 2, a grid in several launches, the window in global scratch."""
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import bn254_r_spec, m128_spec
    from myzkp_tpu_torch.ops import poly

    def values(spec, n, edges):
        vals = edges + [rng.randrange(spec.p) for _ in range(min(n, DIV_EDGE_RANDOM))]
        t = limb.from_int(spec, vals[:n], dev)
        return t.repeat(1, -(-n // t.shape[1]))[:, :n].contiguous()

    rng = random.Random(SEED + 133)
    seen, err = set(), 0
    for spec in (m128_spec(), bn254_r_spec()):
        words = spec.L // 2
        edges = word_edges(spec.p, words)
        for rows, na, bd, what in DIV_EDGE_SHAPES:
            a = values(spec, rows * na, edges).reshape(spec.L, rows, na)
            brows = 1 if "broadcast" in what else rows
            b = values(spec, brows * (bd + 1), edges).reshape(spec.L, brows, bd + 1)
            if "zero lead" in what:
                b[:, min(1, brows - 1), bd] = 0
            if brows == 1:
                b = b[:, 0]
            plan = poly.long_division_plan(rows, na, bd, words, dev)
            mode = plan["mode"]
            if mode == "blocks":
                seen.add("G = 1" if plan["p2"] == 1 else "G >= 2")
                seen |= {"several launches"} if plan["per"] < rows else set()
                seen |= {"global window"} if plan["global_window"] else set()
            seen.add(mode)
            err = max(err, check_equal(f"long_division L = {spec.L} {(rows, na, bd)}",
                                       list(poly.long_division_cuda(spec, a, b, bd)),
                                       list(poly.long_division_ref(spec, a, b, bd))))
    if log_it:
        want = {"rows", "chunks", "blocks", "G = 1", "G >= 2", "several launches",
                "global window"}
        if seen != want:
            raise AssertionError(f"K17's edge shapes missed {sorted(want - seen)}")
        log(f"# bitcheck long_division (M128 and BN254's r) at {len(DIV_EDGE_SHAPES)} "
            f"regime edges ({'; '.join(f'{s[:3]}: {s[3]}' for s in DIV_EDGE_SHAPES)}), "
            f"word edges leading a and b, regimes {sorted(seen)}: exact vs plain")
    return err


# K6 at M128 past the prove's shapes: (E, m, B, stages or None for all): a
# ragged B at both block sizes, B not a multiple of 4 (4-byte copies: at 256
# threads too), small m on 128 threads, the first stages only
LEAF8_EDGES = ((2, 128, 3000, None), (1, 128, 8195, None), (1, 128, 1001, None),
               (3, 64, 37, None), (2, 16, 4099, None), (5, 8, 10, None), (4, 4, 123, None),
               (3, 2, 77, None), (2, 128, 3000, 3), (1, 32, 515, 2))


def bitcheck_leaf8_edges(spec, rng, dev) -> int:
    """K6 (M128) at LEAF8_EDGES, forward and inverse tables and one random
    table (rows not starting with 1), against its plain version."""
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt

    err = 0
    for E, m, B, st in LEAF8_EDGES:
        x = random_fe4(rng, E * m * B, dev, spec).reshape(8, E, m, B)
        tables = [ntt._leaf_twiddles(spec, m, inv, dev) for inv in (False, True)]
        tables.append(random_fe4(rng, m - 1, dev, spec))
        for tw in tables:
            err = max(err, check_equal(f"ntt_leaf_l8 {(E, m, B)} stages {st}",
                                       [nk.ntt_leaf(spec, x, tw, st)],
                                       [nk.ntt_leaf_ref(spec, x, tw, st)]))
    return err


# K5 (M128) against its plain version away from the prove's shapes: (R, Bk,
# c, B, stages, table): B = 3, R off a tile's rows, column counts hq B and
# Bk that are no powers of two, the longest pass and a one-stage pass, 9 and
# 10 stages on 8 columns or more (a tile holds only 4 or 2 of them); the
# table the path's stage rows (entries 0 are R mod p: the j = 0 products
# skipped) or random (every product made)
K5_L8_EDGES = (
    (5, 1, 1024, 3, 10, "path"),     # 10 stages (the plan's most), B = 3
    (131, 1, 64, 1, 6, "path"),      # 131 rows: the last tile ragged in rows
    (3, 1, 8192, 3, 7, "random"),    # a 2^13 first pass at B = 3: 192 columns
    (7, 2, 96, 3, 5, "random"),      # hq B = 9 columns, Bk = 2
    (3, 5, 32, 2, 5, "path"),        # Bk = 5
    (9, 2, 8, 6, 3, "random"),
    (1000, 1, 2, 3, 1, "path"),      # one stage: stored from registers
    (1, 1, 1024, 1, 10, "random"),   # one group, 2 pairs a thread
    (1, 1, 1024, 8, 10, "random"),   # 10 stages on 8 columns: tiles of 2
    (1, 1, 4096, 1, 9, "path"),      # 9 stages on hq = 8 columns: tiles of 4
    (1, 1, 1 << 17, 1, 9, "path"),   # a 2^17-point transform's first pass (9 + 8)
)


def bitcheck_k5_l8_edges(spec, rng, dev) -> int:
    """K5 (M128) at K5_L8_EDGES against butterfly_ref, exact: each input
    (and each random table) leads with the four-word edges (word_edges),
    the rest random."""
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt

    edges = limb.from_int(spec, word_edges(spec.p, 4), dev)
    k = edges.shape[1]

    def leading_edges(n: int) -> torch.Tensor:
        x = random_fe4(rng, n, dev, spec)
        x[:, :min(k, n)] = edges[:, :min(k, n)]
        return x

    err = 0
    for R, Bk, c, B, s, table in K5_L8_EDGES:
        x = leading_edges(R * Bk * c * B).reshape(8, R, Bk, c, B)
        tw = (ntt._pass_twiddles(spec, c, 0, s, False, dev) if table == "path"
              else leading_edges(c - (c >> s)))
        err = max(err, check_equal(f"butterfly_l8 {(R, Bk, c, B)} s = {s} ({table})",
                                   [nk.butterfly(spec, x, tw, s)],
                                   [nk.butterfly_ref(spec, x, tw, s)]))
    return err


def bitcheck_stark_shapes(spec, k5, k6, k17, dev, results: dict) -> None:
    """K5, K6 and K17 at every shape the full-width prove launched them at
    (random inputs of each shape, the path's own tables), against their
    plain versions; K17 where a row takes more than DIV_DIRECT steps (the
    upper levels of the remainder tree and the boundary quotient) against
    the identity a = q b + r instead, by fast_multiply on the card."""
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.ops import ntt, poly

    rng = random.Random(SEED + 129)
    rand = lambda shape: random_fe4(rng, math.prod(shape[1:]), dev, spec).reshape(shape)
    err5 = err6 = err17 = 0
    for (shape, s), ((_, _, tw, *_), _) in k5.items():
        y = rand(shape)
        err5 = max(err5, check_equal(f"butterfly_l8 {shape} s = {s}",
                                     [nk.butterfly(spec, y, tw, s)],
                                     [nk.butterfly_ref(spec, y, tw, s)]))
    for (shape, _), ((_, _, tw, *_), _) in k6.items():
        y = rand(shape)
        err6 = max(err6, check_equal(f"ntt_leaf_l8 {shape}", [nk.ntt_leaf(spec, y, tw)],
                                     [nk.ntt_leaf_ref(spec, y, tw)]))
    identity = []
    for (rows, na, bd), _ in k17.items():
        a, b = rand((8, rows, na)), rand((8, rows, bd + 1))
        q, r = poly.long_division_cuda(spec, a, b, bd)
        if na - bd <= DIV_DIRECT:
            err17 = max(err17, check_equal(f"long_division_l8 {(rows, na, bd)}", [q, r],
                                           list(poly.long_division_ref(spec, a, b, bd))))
        else:
            back = ntt.fast_multiply(Fp(spec, q), Fp(spec, b)) + Fp(spec, r).pad_to(na)
            if not torch.equal(back.mont, a):
                raise AssertionError(f"long_division_l8 {(rows, na, bd)}: a != q b + r")
            identity.append((rows, na, bd))
    err6 = max(err6, bitcheck_leaf8_edges(spec, rng, dev))
    err5 = max(err5, bitcheck_k5_l8_edges(spec, rng, dev))
    results["butterfly_l8"]["max_abs_err"] = err5
    results["ntt_leaf_l8"]["max_abs_err"] = err6
    results["long_division_l8"]["max_abs_err"] = err17
    log(f"# bitcheck butterfly_l8 (M128) at the {len(k5)} (shape, stages) of the prove and "
        f"at {len(K5_L8_EDGES)} edge shapes (R, Bk, c, B, stages, table) {K5_L8_EDGES}, the "
        f"four-word edges leading each input: exact vs plain")
    log(f"# bitcheck ntt_leaf_l8 (M128) at the {len(k6)} (shape, table) pairs of the prove "
        f"and at {len(LEAF8_EDGES)} edge shapes (E, m, B, stages) {LEAF8_EDGES}, forward, "
        f"inverse and a random table: exact vs plain")
    log(f"# bitcheck long_division_l8 (M128) at the {len(k17)} (rows, na, bd) of the prove: "
        f"exact vs plain up to {DIV_DIRECT} steps a row; a == q b + r exactly at "
        f"{identity}")


def stark_cases(spec, k5, k6, k17, dev) -> dict:
    """The timed cases of the four-word kernels and K17 (time_cases), at the
    prove's shapes: K1 at the FRI fold's first products (2^19 x 2^19) and
    the coset scaling (2^20 x 2^20); the chain on hash_batch's S-box (2^20
    elements, alpha^-1); K5 at the prove's widest pass; K6 at the top leaf of
    the 2^20-point coset NTT; K17 at a remainder-tree level whose plain loop
    fits the run (the largest at most DIV_DIRECT steps).  K17's BN254
    instance is timed in phase 15, at its path's shape."""
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt, poly
    from myzkp_tpu_torch.stark import rescue_constants

    rng = random.Random(SEED + 130)
    B4 = LIMB_BYTES4
    n = 1 << LOG_N
    a, b = random_fe4(rng, n, dev, spec), random_fe4(rng, n, dev, spec)
    e = rescue_constants.ALPHA_INV
    sbox = random_fe4(rng, HASH_BATCH, dev, spec)
    (shape5, s5), ((_, _, tw5, *_), _) = max(k5.items(), key=lambda kv: math.prod(kv[0][0]))
    x5 = random_fe4(rng, math.prod(shape5[1:]), dev, spec).reshape(shape5)
    _, R5, Bk5, c5, b5 = shape5
    m5 = Bk5 * c5
    (shape6, _), ((_, _, tw6, *_), _) = max(k6.items(), key=lambda kv: math.prod(kv[0][0]))
    x6 = random_fe4(rng, math.prod(shape6[1:]), dev, spec).reshape(shape6)
    _, E6, m6, B6 = shape6
    rows, na, bd = max((k for k in k17 if k[1] - k[2] <= DIV_DIRECT), key=lambda k: k[2])
    xa, xb = random_fe4(rng, rows * na, dev, spec), random_fe4(rng, rows * (bd + 1), dev, spec)
    da, db = xa.reshape(8, rows, na), xb.reshape(8, rows, bd + 1)
    div_bytes = rows * (na + bd + 1 + na) * B4  # a, b in; q, r out
    div_products = rows * (na - bd) * (bd + 1)
    return {
        "mont_mul_l8": (f"(8, 2^{LOG_N}) x (8, 2^{LOG_N}): a coset scaling of the prove",
                        lambda: limb.mont_mul(spec, a, b),
                        lambda: limb.mont_mul_ref(spec, a, b), 20, 3,
                        bound(3 * B4 * n, n, IMAD_PER_MONT4)),
        "mont_pow_l8": (f"2^{LOG_N} elements, e = alpha^-1 ({e.bit_length()} bits): "
                        f"hash_batch's inverse S-box",
                        lambda: limb.pow_const(spec, sbox, e),
                        lambda: limb.mont_pow_ref(spec, sbox, e), 3, 1,
                        bound(2 * B4 * HASH_BATCH, HASH_BATCH * chain_products(e, 8),
                              IMAD_PER_MONT4)),
        "butterfly_l8": (f"{tuple(shape5)}, stages = {s5}: the prove's widest K5 pass",
                         lambda: nk.butterfly(spec, x5, tw5, s5),
                         lambda: nk.butterfly_ref(spec, x5, tw5, s5), 20, 3,
                         bound(2 * B4 * R5 * m5 * b5 + B4 * (c5 - (c5 >> s5)),
                               R5 * b5 * sum(m5 // 2 - (Bk5 << t) for t in range(s5)),
                               IMAD_PER_MONT4)),
        "ntt_leaf_l8": (f"{tuple(shape6)}: the prove's widest K6 leaf",
                        lambda: nk.ntt_leaf(spec, x6, tw6),
                        lambda: nk.ntt_leaf_ref(spec, x6, tw6), 10, 2,
                        bound(2 * B4 * E6 * m6 * B6 + (m6 - 1) * B4,
                              E6 * B6 * leaf_products(m6), IMAD_PER_MONT4)),
        "long_division_l8": (f"(rows, na, bd) = {(rows, na, bd)}: a remainder-tree level "
                             f"of the prove",
                             lambda: poly.long_division_cuda(spec, da, db, bd),
                             lambda: poly.long_division_ref(spec, da, db, bd), 3, 1,
                             bound(div_bytes, div_products, IMAD_PER_DIV4)),
    }


def time_div_shapes(spec, dev) -> dict:
    """K17 (M128) at each of STARK_DIV_SHAPES on random inputs, with its plan,
    time (graph_time_ms of the wrapper's launches, the leading coefficients'
    inversion included) and bound: a and b read, q and r written, against
    (na - bd)(bd + 1) products a row at IMAD_PER_DIV4; and the sums."""
    from myzkp_tpu_torch.ops import poly

    rng = random.Random(SEED + 134)
    out, total, total_bound = {}, 0.0, 0.0
    for rows, na, bd in STARK_DIV_SHAPES:
        a = random_fe4(rng, rows * na, dev, spec).reshape(8, rows, na)
        b = random_fe4(rng, rows * (bd + 1), dev, spec).reshape(8, rows, bd + 1)
        ms = graph_time_ms(lambda: poly.long_division_cuda(spec, a, b, bd), 2)
        bnd = bound(rows * (2 * na + 1) * LIMB_BYTES4, rows * (na - bd) * (bd + 1),
                    IMAD_PER_DIV4)
        plan = poly.long_division_plan(rows, na, bd, 4, dev)
        out[f"{rows}x{na}x{bd}"] = {"ms": ms, "plan": plan, **bnd}
        total += ms
        total_bound += bnd["bound_ms"]
        shape = ", ".join(str(plan[k]) for k in ("p1", "p2", "T", "S", "per"))
        log(f"# time long_division_l8 {(rows, na, bd)} {plan['mode']} ({shape}): {ms:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    log(f"# time long_division_l8 at the prove's {len(STARK_DIV_SHAPES)} shapes: sum "
        f"{total:.4f} ms against a bound of {total_bound:.4f} ms")
    out["sum_ms"], out["sum_bound_ms"] = total, total_bound
    return out


def time_leaf_shapes(spec, k6, counts: dict, dev) -> dict:
    """K6 (M128) at each (shape, table) one FastStark prove launched it at,
    on random inputs: time (graph_time_ms) and bytes bound (each element
    read and written once, the table read), and the sums over the prove's
    launches (each shape's time times its count)."""
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt

    rng = random.Random(SEED + 135)
    out, total, total_bound = {}, 0.0, 0.0
    for key, ((_, _, tw, *_), _) in sorted(k6.items(), key=lambda kv: -math.prod(kv[0][0])):
        shape = key[0]
        _, E, m, B = shape
        x = random_fe4(rng, E * m * B, dev, spec).reshape(shape)
        ms = graph_time_ms(lambda: nk.ntt_leaf(spec, x, tw), 10)
        bnd = bound(2 * LIMB_BYTES4 * E * m * B + (m - 1) * LIMB_BYTES4,
                    E * B * leaf_products(m), IMAD_PER_MONT4)
        inverse = not torch.equal(tw, ntt._leaf_twiddles(spec, m, False, tw.device))
        n = counts[key]
        out[f"{E}x{m}x{B}{'i' if inverse else ''}"] = {"ms": ms, "launches": n, **bnd}
        total += n * ms
        total_bound += n * bnd["bound_ms"]
    log(f"# time ntt_leaf_l8 by shape (E x m x B, i: inverse): " + ", ".join(
        f"{k} {v['ms']:.4f} ms x {v['launches']}" for k, v in out.items()))
    log(f"# time ntt_leaf_l8 at the prove's {sum(v['launches'] for v in out.values())} launches "
        f"({len(out)} shapes): sum {total:.4f} ms against a bound of {total_bound:.4f} ms")
    out["sum_ms"], out["sum_bound_ms"] = total, total_bound
    return out


def time_stockham_shapes(spec, kt, dev) -> dict:
    """K5 (M128) over each Stockham transform (R, m, B, inverse) one
    FastStark prove ran (kt: a recorder of ops/ntt._stockham_axis), on random
    inputs: the transform's launches timed together (graph_time_ms), its
    bound (each element read and written once at LIMB_BYTES4 and its m - 1
    twiddles read, against R B (k m / 2 - m + 1) products at IMAD_PER_MONT4:
    k = log2 m stages, the j = 0 pair of every block skipped), each pass's
    tiles (ntt_kernels.butterfly_l8_plan); and the sums over the prove's
    transforms (each shape's time and bound times its count)."""
    from myzkp_tpu_torch.fields import ntt_kernels as nk
    from myzkp_tpu_torch.ops import ntt

    rng = random.Random(SEED + 136)
    out, total, total_bound, transforms, launches = {}, 0.0, 0.0, 0, 0
    for (R, m, B, inv), n in sorted(kt.counts.items(), key=lambda kv: (kv[0][1], kv[0][0],
                                                                       kv[0][3])):
        if m < 2:
            continue
        x = random_fe4(rng, R * m * B, dev, spec).reshape(8, R, m, B)
        passes = ntt._stockham_passes(m, spec.L)
        ms = graph_time_ms(lambda: ntt._stockham_axis(spec, x, m, inv), 10)
        k = m.bit_length() - 1
        bnd = bound(2 * LIMB_BYTES4 * R * m * B + LIMB_BYTES4 * (m - 1),
                    R * B * (k * m // 2 - m + 1), IMAD_PER_MONT4)
        plans, Bk = [], 1
        for _, s in passes:
            plans.append(nk.butterfly_l8_plan(R, Bk, m // Bk, B, s, dev))
            Bk <<= s
        out[f"{R}x{m}{'x' + str(B) if B > 1 else ''}{'i' if inv else ''}"] = {
            "count": n, "launches": len(passes), "stages": [s for _, s in passes], "ms": ms,
            "tiles": [(pl["tile"], pl["threads"], pl["blocks"]) for pl in plans], **bnd}
        total += n * ms
        total_bound += n * bnd["bound_ms"]
        transforms += n
        launches += n * len(passes)
    log(f"# time butterfly_l8 by transform (R x m, i: inverse; count, launches a transform, "
        f"(tile, threads, blocks) a pass): " + ", ".join(
            f"{key} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}) x {v['count']}, "
            f"{v['launches']} {v['tiles']}" for key, v in out.items()))
    log(f"# time butterfly_l8 at the prove's {transforms} Stockham transforms ({len(out)} "
        f"shapes, {launches} launches): sum {total:.4f} ms against a bound of "
        f"{total_bound:.4f} ms ({total_bound / total:.1%} of the bound)")
    out["sum_ms"], out["sum_bound_ms"] = total, total_bound
    out["transforms"], out["launches"] = transforms, launches
    return out


def rescue_exactness(dev) -> dict:
    """Rescue-Prime (m = 2, 27 rounds, 28 cycles) through Stark and
    FastStark, on the card and on the CPU plain versions from the same
    seed: the proofs equal byte for byte and each accepted; on the card a
    false output's proof rejected.  Returns the seconds of each prove."""
    import dataclasses

    from myzkp_tpu_torch.stark import fast_stark, rescueprime, stark

    rp = rescueprime.RescuePrime()
    inp = 123456789
    out = rp.hash(inp)
    secs = {}
    for name, init in (("stark", stark.initialize_stark_m128),
                       ("fast_stark", fast_stark.initialize_fast_stark_m128)):
        proofs = {}
        for where in (dev, torch.device("cpu")):
            st = init(4, 2, 2, rp.m, rp.n + 1, 2, device=where)
            air = rp.transition_constraints(st.omicron)
            bnd, false_bnd = rp.boundary_constraints(out), rp.boundary_constraints(out + 1)
            kw = {"preprocessed": st.preprocess()} if name == "fast_stark" else {}
            verify = ((lambda pr, b: st.verify(pr, air, kw["preprocessed"][2], b))
                      if kw else (lambda pr, b: st.verify(pr, air, b)))
            proof, sec = timed(lambda: st.prove(rp.trace(inp), bnd, air,
                                                rng=random.Random(SEED), **kw))
            secs[f"{name} Rescue-Prime {where.type}"] = sec
            if not verify(proof, bnd):
                raise AssertionError(f"{name} Rescue-Prime ({where}): proof rejected")
            if where.type == "cuda":
                bad = st.prove(rp.trace(inp), false_bnd, air, rng=random.Random(SEED + 1), **kw)
                if verify(bad, false_bnd):
                    raise AssertionError(f"{name} Rescue-Prime: a false output accepted")
            proofs[where.type] = dataclasses.asdict(proof)
        if proofs["cuda"] != proofs["cpu"]:
            raise AssertionError(f"{name} Rescue-Prime: the card's proof != the CPU's")
    return secs


def phase_stark(dev, results: dict) -> None:
    import dataclasses
    import importlib

    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import m128_spec
    from myzkp_tpu_torch.ops import ntt, poly
    from myzkp_tpu_torch.stark import fast_stark, rescueprime

    t_phase = time.perf_counter()
    spec = m128_spec()
    p = spec.p
    smi = card()
    phase_bitcheck_m128(dev, results)
    secs = rescue_exactness(dev)
    log(f"# stark Rescue-Prime ({smi}): Stark and FastStark, the card's proof == the CPU "
        f"plain versions' (seed {SEED}), byte for byte; both accepted; on the card a false "
        f"output rejected "
        f"({json.dumps({k: round(v, 3) for k, v in secs.items()})} s)")

    rp = rescueprime.RescuePrime()
    rng = random.Random(SEED + 131)
    inputs = [rng.randrange(p) for _ in range(HASH_BATCH)]
    x = Fp.from_int(spec, inputs, dev)
    before = dict(_ext.launches)
    hashed, sec = timed(lambda: rp.hash_batch(x))
    hb_launches = {k: v - before[k] for k, v in _ext.launches.items() if v != before[k]}
    if hb_launches.get("mont_pow_l8") != 2 * rp.n * rp.m:
        raise AssertionError(f"hash_batch: {hb_launches} launches, not {2 * rp.n * rp.m} of "
                             f"the chain (x^alpha and x^(alpha^-1) a state element a round)")
    results["mont_pow_l8"]["hash_batch_launches"] = hb_launches["mont_pow_l8"]
    picks = rng.sample(range(HASH_BATCH), 64)
    got = Fp(spec, hashed.mont[:, picks]).to_int()
    if [int(g) for g in got] != [rp.hash(inputs[i]) for i in picks]:
        raise AssertionError("hash_batch: a sampled output differs from RescuePrime.hash")
    hb_ms, hb_reps = median_ms(lambda: rp.hash_batch(x), 3)
    secs["hash_batch_first"] = sec
    log(f"# stark hash_batch 2^{LOG_N} ({smi}): 64 sampled outputs == host hash; median "
        f"{hb_ms:.3f} ms of {[round(t, 3) for t in hb_reps]}; launches {json.dumps(hb_launches)} "
        f"(the chain in the {limb.mont_pow_form(HASH_BATCH, dev)} form)")

    st = fast_stark.initialize_fast_stark_m128(*STARK_PARAMS, device=dev)
    trace, air, boundary = squaring_air(spec, STARK_CYCLES)
    pre, secs["preprocess"] = timed(st.preprocess)
    proofs, reps = [], []
    for rep in range(3):  # each from a fresh random.Random(STARK_SEED)
        timers = [split_timer(getattr(importlib.import_module(f"myzkp_tpu_torch.stark.{mod}"),
                                      attr.split(".")[0]), attr.split(".")[1])
                  for mod, attr, _ in STARK_STAGES]
        with contextlib.ExitStack() as stack:
            for t in timers:
                stack.enter_context(t)
            if rep == 0:  # the shapes K5, K6 and K17 run at, and the launch counts
                k5 = stack.enter_context(recorder(
                    nk, "butterfly", lambda _, x, tw, s=1: (tuple(x.shape), s)))
                k6 = stack.enter_context(recorder(
                    nk, "ntt_leaf", lambda _, x, tw, s=None: (tuple(x.shape), tw.data_ptr())))
                k17 = stack.enter_context(recorder(
                    poly, "long_division_cuda",
                    lambda _, a, b, bd: (math.prod(a.shape[1:-1]), a.shape[-1], bd)))
                kt = stack.enter_context(recorder(
                    ntt, "_stockham_axis", lambda _, x, m, inverse: (
                        math.prod(x.shape[1:-2]), m, x.shape[-1], inverse)))
                _ext.reset_launches()
            proof, sec = timed(lambda: st.prove(trace, boundary, air, preprocessed=pre,
                                                rng=random.Random(STARK_SEED)))
            if rep == 0:
                counts = {k: v for k, v in _ext.launches.items() if v}
        split = {"prove_s": sec}
        split.update({name: t.secs for (_, _, name), t in zip(STARK_STAGES, timers)})
        split["other"] = sec - sum(t.secs for t in timers)
        reps.append(split)
        proofs.append(dataclasses.asdict(proof))
    for k in STARK_KERNELS:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"FastStark prove: {k} never launched: {counts}")
    k5_transforms = sum(n for (_, m, _, _), n in kt.counts.items() if m > 1)
    k5_want = sum(n * len(ntt._stockham_passes(m, spec.L))
                  for (_, m, _, _), n in kt.counts.items() if m > 1)
    if not counts["butterfly_l8"] == k5_want <= min(2 * k5_transforms, K5_STARK_LAUNCHES):
        raise AssertionError(f"FastStark prove: {counts['butterfly_l8']} K5 launches for "
                             f"{k5_transforms} Stockham transforms (the split: {k5_want}; at "
                             f"most two a transform and {K5_STARK_LAUNCHES})")
    if any(pr != proofs[0] for pr in proofs[1:]):
        raise AssertionError("FastStark: the proves from one seed differ")
    ok, secs["verify"] = timed(lambda: st.verify(proof, air, pre[2], boundary))
    if not ok:
        raise AssertionError("FastStark 2^20: proof rejected")
    false_bnd = [(0, 0, STARK_X0), (STARK_CYCLES - 1, 0, (trace[-1][0] + 1) % p)]
    bad, secs["false_prove"] = timed(lambda: st.prove(trace, false_bnd, air, preprocessed=pre,
                                                      rng=random.Random(STARK_SEED + 1)))
    ok, secs["false_verify"] = timed(lambda: st.verify(bad, air, pre[2], false_bnd))
    if ok:
        raise AssertionError("FastStark 2^20: a false boundary's proof accepted")
    med = sorted(reps, key=lambda r: r["prove_s"])[1]
    log(f"# stark fast 2^20 ({smi}): {STARK_CYCLES} cycles, FRI domain "
        f"{st.fri.domain_length}; preprocess {secs['preprocess']:.3f} s; prove median "
        f"{med['prove_s']:.3f} s of {[round(r['prove_s'], 3) for r in reps]} (the three "
        f"proofs equal); verify {secs['verify']:.4f} s: accepted; a false boundary's "
        f"prove {secs['false_prove']:.3f} s, verify {secs['false_verify']:.4f} s: rejected")
    log(f"# stark prove split (median rep, s): "
        f"{json.dumps({k: round(v, 4) for k, v in med.items()})}")
    log(f"# stark prove launches: {json.dumps(counts)}; K5 {counts['butterfly_l8']} for "
        f"{k5_transforms} Stockham transforms (at most two a transform: "
        f"{K5_STARK_LAUNCHES})")

    if set(k17.calls) != set(STARK_DIV_SHAPES):
        raise AssertionError(f"FastStark prove: K17 at {sorted(k17.calls)}, not "
                             f"STARK_DIV_SHAPES")
    bitcheck_stark_shapes(spec, k5.calls, k6.calls, k17.calls, dev, results)
    err = bitcheck_div_edges(dev)
    results["long_division"]["max_abs_err"] = err
    results["long_division_l8"]["max_abs_err"] = max(
        results["long_division_l8"]["max_abs_err"], err)
    time_cases(stark_cases(spec, k5.calls, k6.calls, k17.calls, dev), results)
    k17_shapes = time_div_shapes(spec, dev)
    k6_shapes = time_leaf_shapes(spec, k6.calls, k6.counts, dev)
    k5_shapes = time_stockham_shapes(spec, kt, dev)
    for k in results:
        if not k.startswith("_"):
            results[k]["stark_launches"] = counts.get(k, 0)
    for k in STARK_KERNELS + ("long_division", "fe_add_l8", "fe_sub_l8"):
        results[k]["launches"] = counts.get(k, 0)
    secs["phase"] = time.perf_counter() - t_phase
    results["_stark"] = {"card": smi, "prove_median": med, "reps": reps, "seconds": secs,
                         "launches": counts, "hash_batch_ms": hb_ms,
                         "hash_batch_reps_ms": hb_reps, "hash_batch_launches": hb_launches,
                         "k17_shapes": k17_shapes, "k6_shapes": k6_shapes,
                         "k5_shapes": k5_shapes}
    log(f"# stark phase {secs['phase']:.1f} s")


DAS_SEED = SEED + 140
EFIELD_N = 1 << 20
CELESTIA_K, CELESTIA_EXPANSION = 128, 2.0  # a 128 x 128 original square
CELESTIA_SAMPLES = 16  # the CLI's base_num_sampling
AVAIL_BYTES, AVAIL_CHUNK, AVAIL_EXPANSION, AVAIL_SAMPLES = 1 << 20, 8, 2.0, 8
EIGENDA_BYTES, EIGENDA_EXPANSION, EIGENDA_OPERATORS, EIGENDA_SAMPLES = 1024, 4.0, 8, 5
DAS_S = 0x2A9C41F75B3E0D6897C211F46E0B83D5  # the Avail key's toxic waste: the host checks


def random_fe64(rng: np.random.Generator, n: int, dev) -> torch.Tensor:
    """n canonical M64 limb columns (4, n): the top limb below 0xFFFF keeps
    each value below 2^64 - 2^48 < p."""
    limbs = rng.integers(0, 1 << 16, size=(4, n), dtype=np.int64)
    limbs[3] = rng.integers(0, 0xFFFF, size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def phase_bitcheck_m64(dev, results: dict) -> None:
    """K1 and its chain at two words (M64) against their plain versions and
    the host: K1 on 2^20 pairs, every pair of the two-word edges first; the
    chain at 1, 2, 3, 16, 4,097 and 2^20 elements (the edges first) for
    e = 0, 1, 2, p - 2 and a seeded 256-bit e."""
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import m64_spec

    spec = m64_spec()
    p, R = spec.p, 1 << 64
    rng = np.random.default_rng(SEED + 64)
    edges = word_edges(p, 2)
    k = len(edges) ** 2
    n = 1 << LOG_N
    a, b = random_fe64(rng, n, dev), random_fe64(rng, n, dev)
    a[:, :k] = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    b[:, :k] = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    before = _ext.launches["mont_mul_l4"]
    got = limb.mont_mul(spec, a, b)
    if _ext.launches["mont_mul_l4"] != before + 1:
        raise AssertionError("mont_mul (M64): not one launch of mont_mul_l4")
    err = check_equal("mont_mul_l4", [got], [limb.mont_mul_ref(spec, a, b)])
    rinv = pow(R, -1, p)
    gi = limb.to_int(spec, got[:, :k])
    if any(int(g) != x * y * rinv % p
           for g, (x, y) in zip(gi, ((x, y) for x in edges for y in edges))):
        raise AssertionError("mont_mul_l4: disagrees with the host on the word edges")
    results["mont_mul_l4"]["max_abs_err"] = err
    log(f"# bitcheck mont_mul_l4 (M64): 2^{LOG_N} pairs, the first {k} every pair of "
        f"{len(edges)} word edges (each 32-bit word 0 or 0xFFFFFFFF below p; p - 1, 1, "
        f"R mod p; 2^63, 2^63 + 1, 2^63 + 2^32 - 1, p - 2): exact, and the edge pairs == host")
    err = 0
    exps = (0, 1, 2, p - 2, int(rng.integers(1, 1 << 62)) << 194 | 12345)
    for m in POW_SIZES + (n,):
        x = random_fe64(rng, m, dev)
        x[:, :min(m, len(edges))] = limb.from_int(spec, edges[:m], dev)
        xs = [int(v) * rinv % p for v in limb.to_int(spec, x[:, :64])]
        for e in exps:
            before = _ext.launches["mont_pow_l4"]
            got = limb.pow_const(spec, x, e)
            if _ext.launches["mont_pow_l4"] != before + 1:
                raise AssertionError("pow_const (M64): not one launch of the chain")
            err = max(err, check_equal(f"mont_pow_l4 n = {m} e = {e}", [got],
                                       [limb.mont_pow_ref(spec, x, e)]))
            if any(int(g) != pow(v, e, p) * R % p
                   for g, v in zip(limb.to_int(spec, got[:, :64]), xs)):
                raise AssertionError(f"mont_pow_l4 n = {m} e = {e}: differs from the host")
    results["mont_pow_l4"]["max_abs_err"] = max(results["mont_pow_l4"].get("max_abs_err", 0), err)
    log(f"# bitcheck mont_pow_l4 (M64): {POW_SIZES + (n,)} elements (the word edges first), "
        f"e = 0, 1, 2, p - 2 and a seeded 256-bit e, one launch each: exact vs plain and the "
        f"first 64 == host")


def cubic_mul(x, y, p: int) -> list:
    """The M64 cubic's product on the host: x^3 = x - 1, x^4 = x^2 - x."""
    c = [0] * 5
    for i in range(3):
        for j in range(3):
            c[i + j] += x[i] * y[j]
    return [(c[0] - c[3]) % p, (c[1] + c[3] - c[4]) % p, (c[2] + c[4]) % p]


def cubic_pow(x, e: int, p: int) -> list:
    acc, base = [1, 0, 0], list(x)
    while e:
        if e & 1:
            acc = cubic_mul(acc, base, p)
        base = cubic_mul(base, base, p)
        e >>= 1
    return acc


def efield_mul_launches(es, width: str, calls: int = 1) -> dict:
    """The launches of ``calls`` efield.mul calls: two of K1 (the products,
    the reduction's) and K18's adds, k^2 - (2k - 1) folding the products
    into columns and one a reduction term."""
    adds = es.k ** 2 - (2 * es.k - 1) + len(es.red_terms)
    return {"mont_mul" + width: 2 * calls, "fe_add" + width: adds * calls}


def das_efield(dev, smi: str, counts: dict, secs: dict) -> None:
    """The M64 cubic at 2^20 elements (mul, inv, pow_const) and BN254's Fq2
    through the generic machinery against the Karatsuba path."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.fields import efield, limb

    es = efield.m64_cubic()
    p, n = es.base.p, EFIELD_N
    rng = np.random.default_rng(DAS_SEED)
    a = torch.stack([random_fe64(rng, n, dev) for _ in range(3)])
    b = torch.stack([random_fe64(rng, n, dev) for _ in range(3)])
    edges = word_edges(p, 2)  # edges[0] = 0: element 1 is zero too
    a[:, :, 1:1 + len(edges)] = limb.from_int(es.base, [edges] * 3, dev).transpose(0, 1)
    a[:, :, [0, n - 1]] = 0
    e = int(rng.integers(1, 1 << 62)) << 128 | int(rng.integers(0, 1 << 62))

    run = functools.partial(run_counted, counts, secs)

    prod = run("efield_mul", lambda: efield.mul(es, a, b))
    if counts["efield_mul"] != efield_mul_launches(es, "_l4"):
        raise AssertionError(f"efield mul 2^20: launches {counts['efield_mul']}, not "
                             f"{efield_mul_launches(es, '_l4')}")
    ainv = run("efield_inv", lambda: efield.inv(es, a))
    nbits = (p ** 3 - 2).bit_length()
    inv_launches = efield_mul_launches(es, "_l4", nbits)
    if counts["efield_inv"] != inv_launches:
        raise AssertionError(f"efield inv 2^20: launches {counts['efield_inv']}, not "
                             f"{inv_launches}")
    apow = run("efield_pow", lambda: efield.pow_const(es, a, e))
    nz = ~efield.is_zero(es, a)
    if not efield.eq(es, efield.mul(es, a, ainv), efield.one(es, (n,), dev))[nz].all():
        raise AssertionError("efield inv 2^20: a * inv(a) != 1 where a != 0")
    if ainv[:, :, ~nz].any() or nz[[0, 1, n - 1]].any():
        raise AssertionError("efield inv 2^20: inv(0) != 0")
    cpu = lambda t, m: t[:, :, :m].cpu()
    for name, got, fn, m in (
            ("mul", prod, lambda: efield.mul(es, cpu(a, 4096), cpu(b, 4096)), 4096),
            ("inv", ainv, lambda: efield.inv(es, cpu(a, 256)), 256),
            ("pow_const", apow, lambda: efield.pow_const(es, cpu(a, 256), e), 256)):
        if not torch.equal(cpu(got, m), fn()):
            raise AssertionError(f"efield {name}: the card's first {m} != the CPU plain "
                                 f"versions'")
    idx = [int(i) for i in rng.choice(n, 64, replace=False)] + [0, 1]
    A, B = efield.to_int_coeffs(es, a[:, :, idx]), efield.to_int_coeffs(es, b[:, :, idx])
    for name, got, want in (
            ("mul", prod, lambda x, y: cubic_mul(x, y, p)),
            ("pow_const", apow, lambda x, _: cubic_pow(x, e, p)),
            ("inv", ainv, lambda x, _: cubic_pow(x, p ** 3 - 2, p))):
        G = efield.to_int_coeffs(es, got[:, :, idx])
        if any([int(v) for v in g] != want([int(v) for v in x], [int(v) for v in y])
               for g, x, y in zip(G, A, B)):
            raise AssertionError(f"efield {name}: a sampled element differs from the host")
    ms = {"mul": median_ms(lambda: efield.mul(es, a, b), 3),
          "inv": median_ms(lambda: efield.inv(es, a), 3),
          "pow_const": median_ms(lambda: efield.pow_const(es, a, e), 3)}

    fq, F2 = efield.bn254_fq2(), bn254.g2_ops()
    qrng = np.random.default_rng(DAS_SEED + 1)
    x0, x1, y0, y1 = (random_fe(qrng, n, dev) for _ in range(4))
    X, Y = torch.stack([x0, x1]), torch.stack([y0, y1])
    gen = run("fq2_generic", lambda: efield.mul(fq, X, Y))
    kar = torch.stack(F2.mul((x0, x1), (y0, y1)))
    if not torch.equal(gen, kar) or counts["fq2_generic"] != efield_mul_launches(fq, ""):
        raise AssertionError(f"bn254_fq2 mul 2^20: != Fq2Ops.mul, or launches "
                             f"{counts['fq2_generic']} are not "
                             f"{efield_mul_launches(fq, '')}")
    ms["fq2_generic"] = median_ms(lambda: efield.mul(fq, X, Y), 3)
    ms["fq2_karatsuba"] = median_ms(lambda: F2.mul((x0, x1), (y0, y1)), 3)
    secs["efield_ms"] = ms
    log(f"# das efield M64 cubic 2^{n.bit_length() - 1} ({smi}): mul launches "
        f"{efield_mul_launches(es, '_l4')}, inv {inv_launches}, pow_const "
        f"({e.bit_length()} bits) {counts['efield_pow']}; a x inv(a) = 1 where a != 0, inv(0) = 0; "
        f"66 sampled == host ints, the first 4,096 / 256 == CPU plain; "
        f"Fq2 generic == Karatsuba at 2^{n.bit_length() - 1} "
        f"({efield_mul_launches(fq, '')}); median ms of 3: "
        f"{json.dumps({k: round(v[0], 3) for k, v in ms.items()})}")


def das_celestia(dev, smi: str, counts: dict, secs: dict) -> None:
    """Celestia at a 128 x 128 original square (a 256 x 256 extended one)."""
    from myzkp_tpu_torch.codes import reedsolomon as rs
    from myzkp_tpu_torch.das.celestia import Celestia, EncodedDataCelestia
    from myzkp_tpu_torch.das.utils import SamplePosition
    from myzkp_tpu_torch.utils import merkle

    k = CELESTIA_K
    size = k * k
    data = np.random.default_rng(DAS_SEED + 2).integers(0, 256, size, dtype=np.uint8).tobytes()
    params = Celestia.setup(k, CELESTIA_EXPANSION, size, device=dev)
    side = params.codeword_size

    run = functools.partial(run_counted, counts, secs)

    enc = run("celestia_encode", lambda: Celestia.encode(data, params))
    sq = enc.cells
    coder = rs.setup_rs2d(side, side, size)
    cpu = rs.encode_rs2d_batch(torch.frombuffer(bytearray(data), dtype=torch.uint8), coder)
    if sq.shape != (side, side) or not np.array_equal(sq, cpu.numpy()):
        raise AssertionError("celestia: the card's square != the CPU parity-matrix encode")
    d = side - k
    pick = random.Random(DAS_SEED).sample(range(k), 4)
    for r in pick:
        if rs.encode_rs1d(data[r * k:(r + 1) * k], coder.row_coder) != sq[d + r].tolist():
            raise AssertionError(f"celestia: row {d + r} != the object-level row coder")
    for c in pick:
        if rs.encode_rs1d(sq[d:, c].tolist(), coder.col_coder) != sq[:, c].tolist():
            raise AssertionError(f"celestia: column {c} != the object-level column coder")
    com = run("celestia_commit", lambda: Celestia.commit(enc, params))
    if (len(com.row_roots), len(com.col_roots)) != (side, side) or \
            com.data_root != merkle.commit(com.row_roots + com.col_roots):
        raise AssertionError("celestia: the roots are not 2 x 256 under the data root")
    positions = [SamplePosition(i // side, i % side, False) for i in range(CELESTIA_SAMPLES)]
    rowpos = SamplePosition(3, side - 7, True)
    ok = run("celestia_verify", lambda: [Celestia.verify(q, enc, com, params)
                                         for q in positions + [rowpos]])
    bad = EncodedDataCelestia(codewords=enc.codewords.clone(), data_size=size)
    bad.codewords[0, 5] ^= 1
    if not all(ok) or Celestia.verify(positions[5], bad, com, params):
        raise AssertionError(f"celestia: samples {ok}, or a tampered leaf accepted")
    ms = {"encode": median_ms(lambda: Celestia.encode(data, params), 3),
          "commit": median_ms(lambda: Celestia.commit(enc, params), 3),
          "verify_16": median_ms(lambda: [Celestia.verify(q, enc, com, params)
                                          for q in positions], 3)}
    secs["celestia_ms"] = ms
    log(f"# das celestia {k} x {k} -> {side} x {side} ({smi}): == CPU parity-matrix encode, "
        f"4 rows and 4 columns == object-level coder; {2 * side} roots + data root; "
        f"{CELESTIA_SAMPLES} column samples and a row sample verified, a tampered leaf "
        f"rejected; median ms of 3: {json.dumps({k: round(v[0], 3) for k, v in ms.items()})}")


def das_avail(dev, smi: str, counts: dict, secs: dict) -> None:
    """Avail over a 2^20-byte blob: chunk 8, expansion 2, KZG from a known s."""
    from myzkp_tpu_torch.codes import reedsolomon as rs
    from myzkp_tpu_torch.commit import kzg
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.das.avail import Avail, CommitmentAvail, PublicParamsAvail
    from myzkp_tpu_torch.das.utils import SamplePosition

    R = bn254.R
    data = np.random.default_rng(DAS_SEED + 3).integers(
        0, 256, AVAIL_BYTES, dtype=np.uint8).tobytes()
    rows = math.ceil(AVAIL_BYTES / AVAIL_CHUNK)

    run = functools.partial(run_counted, counts, secs)

    pk = run("avail_setup", lambda: kzg.setup(rows, s=DAS_S, device=dev))
    params = PublicParamsAvail(AVAIL_EXPANSION, pk, AVAIL_CHUNK)
    enc = run("avail_encode", lambda: Avail.encode(data, params))
    width = AVAIL_CHUNK * math.ceil(AVAIL_EXPANSION)
    cpu = rs.encode_rs1d_batch(torch.frombuffer(bytearray(data), dtype=torch.uint8).reshape(
        rows, AVAIL_CHUNK), rs.setup_rs1d(width, AVAIL_CHUNK))
    if tuple(enc.codewords.shape) != (rows, width) or not torch.equal(enc.codewords.cpu(), cpu):
        raise AssertionError("avail: the card's codewords != the CPU parity-matrix encode")
    com = run("avail_commit", lambda: Avail.commit(enc, params))
    cols = cpu.numpy().T.astype(object)
    if com.commitments != [bn254.g1_generator() * horner(list(c), DAS_S, R) for c in cols]:
        raise AssertionError("avail: a column commitment != the host's [p(s)]G1")
    positions = [SamplePosition(0, i, False) for i in range(AVAIL_SAMPLES)]
    ok = run("avail_verify", lambda: [Avail.verify(q, enc, com, params) for q in positions])
    other = CommitmentAvail(commitments=com.commitments[1:] + com.commitments[:1])
    if not all(ok) or Avail.verify(positions[0], enc, other, params):
        raise AssertionError(f"avail: samples {ok}, or another column's commitment accepted")
    ms = {"encode": median_ms(lambda: Avail.encode(data, params), 3),
          "commit": median_ms(lambda: Avail.commit(enc, params), 3),
          "verify_8": median_ms(lambda: [Avail.verify(q, enc, com, params)
                                         for q in positions], 3)}
    secs["avail_ms"] = ms
    log(f"# das avail {AVAIL_BYTES} bytes ({smi}): {rows} rows x {width}, == CPU encode; "
        f"KZG degree {rows} in {secs['avail_setup']:.3f} s; {width} commitments == host [p(s)]G1; "
        f"{AVAIL_SAMPLES} samples verified, another column's commitment rejected; median "
        f"ms of 3: {json.dumps({k: round(v[0], 3) for k, v in ms.items()})}")


def das_eigenda(dev, smi: str, counts: dict, secs: dict) -> None:
    """EigenDA at the CLI's top size: 1,024 bytes, expansion 4, 8 chunks."""
    from myzkp_tpu_torch.codes import reedsolomon as rs
    from myzkp_tpu_torch.das.eigenda import CommitmentEigenDA, EigenDA
    from myzkp_tpu_torch.das.utils import SamplePosition

    data = np.random.default_rng(DAS_SEED + 4).integers(
        0, 256, EIGENDA_BYTES, dtype=np.uint8).tobytes()
    chunk = int(EIGENDA_BYTES * EIGENDA_EXPANSION / EIGENDA_OPERATORS)

    run = functools.partial(run_counted, counts, secs)

    params = run("eigenda_setup", lambda: EigenDA.setup(chunk, EIGENDA_EXPANSION,
                                                        EIGENDA_BYTES, device=dev))
    enc = run("eigenda_encode", lambda: EigenDA.encode(data, params))
    n = int(EIGENDA_BYTES * EIGENDA_EXPANSION)
    cpu = rs.encode_rs1d_batch(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                               rs.setup_rs1d(n, EIGENDA_BYTES))
    if [c.numel() for c in enc.codewords] != [chunk] * EIGENDA_OPERATORS or \
            not torch.equal(torch.cat(enc.codewords).cpu(), cpu):
        raise AssertionError("eigenda: the card's chunks != the CPU parity-matrix encode")
    com = run("eigenda_commit", lambda: EigenDA.commit(enc, params))
    positions = [SamplePosition(0, i, False) for i in range(EIGENDA_SAMPLES)]
    ok = run("eigenda_verify", lambda: [EigenDA.verify(q, enc, com, params) for q in positions])
    y, w = com.chunk_proofs[0]
    bad = CommitmentEigenDA(com.chunk_commitments, [(y + 1, w)] + com.chunk_proofs[1:], 0)
    if not all(ok) or EigenDA.verify(positions[0], enc, bad, params):
        raise AssertionError(f"eigenda: samples {ok}, or a changed y accepted")
    ms = {"encode": median_ms(lambda: EigenDA.encode(data, params), 3),
          "commit": median_ms(lambda: EigenDA.commit(enc, params), 3),
          "verify_5": median_ms(lambda: [EigenDA.verify(q, enc, com, params)
                                         for q in positions], 3)}
    secs["eigenda_ms"] = ms
    log(f"# das eigenda {EIGENDA_BYTES} bytes ({smi}): {n}-symbol codeword in "
        f"{EIGENDA_OPERATORS} chunks of {chunk}, == CPU encode; {EIGENDA_SAMPLES} samples "
        f"verified, a changed y rejected; median ms of 3: "
        f"{json.dumps({k: round(v[0], 3) for k, v in ms.items()})}")


def phase_das(dev, results: dict, sass: dict) -> None:
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.spec import m64_spec

    t_phase = time.perf_counter()
    smi = card()
    phase_bitcheck_m64(dev, results)
    counts, secs = {}, {}
    das_efield(dev, smi, counts, secs)
    das_celestia(dev, smi, counts, secs)
    das_avail(dev, smi, counts, secs)
    das_eigenda(dev, smi, counts, secs)

    spec = m64_spec()
    rng = np.random.default_rng(DAS_SEED + 5)
    n = 1 << LOG_N
    x, y, z = (random_fe64(rng, n, dev) for _ in range(3))
    e = spec.p - 2
    time_cases({
        "mont_mul_l4": (f"(4, 2^{LOG_N}) x (4, 2^{LOG_N})",
                        lambda: limb.mont_mul(spec, x, y), lambda: limb.mont_mul_ref(spec, x, y),
                        20, 3, bound(3 * LIMB_BYTES2 * n, n, IMAD_PER_MONT2)),
        "mont_pow_l4": (f"2^{LOG_N} elements, e = p - 2: the base field's inversion",
                        lambda: limb.pow_const(spec, z, e),
                        lambda: limb.mont_pow_ref(spec, z, e), 3, 1,
                        bound(2 * LIMB_BYTES2 * n, n * chain_products(e, 4), IMAD_PER_MONT2)),
    }, results)
    # every bound counts the interface's bytes (an int32 a 16-bit limb);
    # at two words the value's own 8 B give a bound half that
    k1 = results["mont_mul_l4"]
    value_ms = 3 * VALUE_BYTES2 * n / HBM_BYTES_PER_S * 1e3
    log(f"# das K1 at two words ({smi}): {k1['ms']:.4f} ms; bytes bound at the interface's "
        f"{LIMB_BYTES2} B an element {k1['bound_ms']:.4f} ms "
        f"({100 * k1['bound_ms'] / k1['ms']:.1f}%), at the value's {VALUE_BYTES2} B "
        f"{value_ms:.4f} ms ({100 * value_ms / k1['ms']:.1f}%)")
    log(f"# das K1 at two words: SASS IMAD mont_mul_l4_kernel "
        f"{sass.get('mont_mul_l4_kernel', {}).get('IMAD')}, mont_pow_l4_kernel "
        f"{sass.get('mont_pow_l4_kernel', {}).get('IMAD')} (the bound counts "
        f"{IMAD_PER_MONT2} a product)")

    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    for k in results:
        if not k.startswith("_"):
            results[k]["das_launches"] = total.get(k, 0)
    path = ("efield_mul", "efield_inv", "efield_pow")
    for k in ("mont_mul_l4", "mont_pow_l4", "fe_add_l4", "fe_sub_l4"):
        results[k]["launches"] = sum(counts[r].get(k, 0) for r in path)
    if results["mont_mul_l4"]["launches"] < 1:
        raise AssertionError("das: mont_mul_l4 never launched on the efield path")
    secs["phase"] = time.perf_counter() - t_phase
    results["_das"] = {"card": smi, "seconds": {k: v for k, v in secs.items()
                                                if not k.endswith("_ms")},
                       "median_ms": {k: v for k, v in secs.items() if k.endswith("_ms")},
                       "launches": counts, "mont_mul_l4_value_bound_ms": value_ms}
    log(f"# das launches: {json.dumps(counts)}")
    log(f"# das phase {secs['phase']:.1f} s")


# Phase 15: the dense R1CS / QAP under Pinocchio and Groth16, the host GT
# pairing and the tutorial ladders, and serialize, checkpoint, the stage
# spans and the two module entry points.
LOG_M_ROU, LOG_M_NAT = 12, 9  # the dense QAP: root-of-unity and natural domains
DENSE_SEED = SEED + 150
NAT_DIV = (1, 2 * (1 << LOG_M_NAT) - 1, 1 << LOG_M_NAT)  # h = (ell r - o) / t: K17's shape
LOG_CKPT, LOG_CKPT_CHUNK = 20, 18  # msm_resumable over 2^20 points in chunks of 2^18
SNARK_CLI_LOG_M, SUMCHECK_CLI_VARS = 12, 8
DENSE_PROVE_KERNELS = ("mont_mul", "mont_pow", "padd", "pdbl", "bucket_scan_rows", "butterfly",
                       "padd2", "pdbl2", "bucket_scan_rows2", "gather_planes", "scatter_rows")


def densify(mat):
    """A sparse matrix (unique entries) as the dense (m, d) Fp on its device."""
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.fp import Fp

    spec = mat.vals.spec
    out = limb.zeros(spec, mat.shape, mat.rows.device)
    out[:, mat.rows, mat.cols] = mat.vals.mont
    return Fp(spec, out)


def dense_case(spec, m: int, domain: str, dev):
    """square_chain(m) as a dense QAP over ``domain``, its sparse QAP and the
    assignment."""
    from myzkp_tpu_torch.arith import sparse
    from myzkp_tpu_torch.arith.qap import QAP
    from myzkp_tpu_torch.arith.r1cs import R1CS

    r1cs, asg = sparse.square_chain(spec, m, device=dev)
    dense = R1CS(*(densify(x) for x in (r1cs.left, r1cs.right, r1cs.out)))
    if not dense.is_satisfied(asg):
        raise AssertionError(f"dense square_chain(2^{m.bit_length() - 1}): not satisfied")
    return QAP.from_r1cs(dense, domain), sparse.SparseQAP(r1cs), asg


def same_keys(a, b) -> bool:
    """Two keys (dataclasses of device point batches, host points, ints)
    equal field for field, the device batches limb for limb."""
    from myzkp_tpu_torch.curves import weierstrass as wst

    for f, x in vars(a).items():
        y = getattr(b, f)
        if isinstance(x, wst.Point):
            if not all(torch.equal(s, t) for s, t in zip(wst.leaves(x), wst.leaves(y))):
                return False
        elif x != y:
            return False
    return True


def launch_line(name: str, counts: dict) -> None:
    log(f"# dense {name} launches: {json.dumps(counts)}")
    missing = [k for k in DENSE_PROVE_KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"dense {name}: {missing} never launched: {counts}")


def dense_rou(dev, spec, smi: str, out: dict) -> tuple:
    """Pinocchio and Groth16 on the dense root-of-unity QAP of
    square_chain(2^12), keys and proofs against the sparse QAP's."""
    from myzkp_tpu_torch.snark import groth16 as g16
    from myzkp_tpu_torch.snark import pinocchio as pin

    m = 1 << LOG_M_ROU
    torch.cuda.reset_peak_memory_stats()
    qap, sqap, asg = dense_case(spec, m, "rou", dev)
    bad = _wrong_witness(asg, m // 2)
    rng = lambda k: random.Random(DENSE_SEED + k)
    (pk, vk), setup_s = timed(lambda: pin.setup(qap, rng(0)))
    spk, svk = pin.setup(sqap, rng(0))
    if vk != svk or not same_keys(pk, spk):
        raise AssertionError("dense rou 2^12: Pinocchio keys differ from the sparse QAP's")
    torch.cuda.reset_peak_memory_stats()
    proof, counts = counted(lambda: pin.prove(asg, pk, qap, rng(1)))
    peak_prove = torch.cuda.max_memory_allocated()
    launch_line("rou pinocchio prove", counts)
    if proof != pin.prove(asg, spk, sqap, rng(1)):
        raise AssertionError("dense rou 2^12: the proof differs from the sparse QAP's")
    ok = pin.verify(proof, vk)
    if not ok or pin.verify(pin.prove(bad, pk, qap, rng(1)), vk):
        raise AssertionError("dense rou 2^12: Pinocchio accepted a wrong witness or "
                             "rejected the witness")
    med, reps = median_ms(lambda: pin.prove(asg, pk, qap, rng(1)), 3)
    smed, sreps = median_ms(lambda: pin.prove(asg, spk, sqap, rng(1)), 3)
    gpk, gvk = g16.setup(qap, 1, rng(2))
    sgpk, sgvk = g16.setup(sqap, 1, rng(2))
    if not (same_keys(gpk, sgpk) and same_keys(gvk, sgvk)):
        raise AssertionError("dense rou 2^12: Groth16 keys differ from the sparse QAP's")
    gproof, gcounts = counted(lambda: g16.prove(asg, gpk, qap, rng(3)))
    launch_line("rou groth16 prove", gcounts)
    if gproof != g16.prove(asg, sgpk, sqap, rng(3)):
        raise AssertionError("dense rou 2^12: the Groth16 proof differs from the sparse QAP's")
    gmed, greps = median_ms(lambda: g16.prove(asg, gpk, qap, rng(3)), 3)
    if not g16.verify(gproof, gvk, [1]) or g16.verify(g16.prove(bad, gpk, qap, rng(3)),
                                                     gvk, [1]):
        raise AssertionError("dense rou 2^12: Groth16 accepted a wrong witness or "
                             "rejected the witness")
    peak = torch.cuda.max_memory_allocated()
    out["rou"] = {"pinocchio_setup_s": setup_s, "pinocchio_prove_ms": med,
                  "pinocchio_prove_reps_ms": reps, "sparse_prove_ms": smed,
                  "sparse_prove_reps_ms": sreps, "groth16_prove_ms": gmed,
                  "groth16_prove_reps_ms": greps, "peak_prove_bytes": peak_prove,
                  "peak_bytes": peak, "pinocchio_launches": counts,
                  "groth16_launches": gcounts}
    log(f"# dense rou m = 2^{LOG_M_ROU} ({smi}): d = {qap.d}, three ({m}, {qap.d}) matrices; "
        f"Pinocchio and Groth16 (1 public input) keys equal to the sparse QAP's batch for "
        f"batch and proofs point for point, same seeds; both accepted, a wrong witness "
        f"rejected by both; Pinocchio setup {setup_s:.3f} s, prove median {med:.2f} ms of "
        f"{[round(t, 2) for t in reps]} (the sparse QAP's {smed:.2f} ms of "
        f"{[round(t, 2) for t in sreps]}); Groth16 prove median {gmed:.2f} ms of "
        f"{[round(t, 2) for t in greps]}; peak memory {peak_prove / 2**30:.3f} GiB in the "
        f"prove, {peak / 2**30:.3f} GiB from the dense matrices on")
    return qap, pk, vk, asg, counts, gcounts


def dense_natural(dev, spec, smi: str, results: dict, out: dict) -> dict:
    """Pinocchio on the dense natural-domain QAP of square_chain(2^9): K17
    divides h = (ell r - o) / t in the prove, held bit for bit against its
    plain version at that call; h t = ell r - o at a random s on the host."""
    from myzkp_tpu_torch.ops import poly
    from myzkp_tpu_torch.snark import pinocchio as pin

    m = 1 << LOG_M_NAT
    torch.cuda.reset_peak_memory_stats()
    (qap, _, asg), qap_s = timed(lambda: dense_case(spec, m, "natural", dev))
    peak_qap = torch.cuda.max_memory_allocated()
    rng = lambda k: random.Random(DENSE_SEED + 10 + k)
    (pk, vk), setup_s = timed(lambda: pin.setup(qap, rng(0)))
    with recorder(poly, "long_division_cuda",
                  lambda _, a, b, bd: (math.prod(a.shape[1:-1]), a.shape[-1], bd)) as k17:
        (proof, counts), prove_s = timed(lambda: counted(
            lambda: pin.prove(asg, pk, qap, rng(1))))
    launch_line("natural pinocchio prove", counts)
    if counts.get("long_division", 0) < 1 or set(k17.calls) != {NAT_DIV}:
        raise AssertionError(f"dense natural 2^{LOG_M_NAT}: K17 at {sorted(k17.calls)}, "
                             f"{counts.get('long_division', 0)} launches; expected {NAT_DIV}")
    (_, a, b, bd), _ = k17.calls[NAT_DIV]
    err = check_equal(f"long_division {NAT_DIV} (the prove's h)",
                      list(poly.long_division_cuda(spec, a, b, bd)),
                      list(poly.long_division_ref(spec, a, b, bd)))
    results["long_division"]["max_abs_err"] = max(results["long_division"]["max_abs_err"], err)
    ok = pin.verify(proof, vk)
    if not ok or pin.verify(pin.prove(_wrong_witness(asg, m // 2), pk, qap, rng(1)), vk):
        raise AssertionError(f"dense natural 2^{LOG_M_NAT}: Pinocchio accepted a wrong "
                             f"witness or rejected the witness")
    # h(s) t(s) = ell(s) r(s) - o(s) on the host, by Horner
    p = spec.p
    s = random.Random(DENSE_SEED + 19).randrange(p)
    ev = lambda poly_: horner([int(c) for c in poly_.to_int()], s, p)
    ell, r, o = (ev(x) for x in qap.combine(asg))
    h, t = ev(qap.h_poly(asg)), ev(poly.Poly(qap.t))
    if h * t % p != (ell * r - o) % p:
        raise AssertionError(f"dense natural 2^{LOG_M_NAT}: h(s) t(s) != ell(s) r(s) - o(s)")
    out["natural"] = {"qap_s": qap_s, "peak_qap_bytes": peak_qap, "setup_s": setup_s,
                      "prove_s": prove_s, "launches": counts}
    log(f"# dense natural m = 2^{LOG_M_NAT} ({smi}): QAP (three batched Lagrange "
        f"interpolations) {qap_s:.3f} s, peak {peak_qap / 2**30:.2f} GiB; setup {setup_s:.3f} "
        f"s; prove {prove_s:.3f} s with K17 {counts['long_division']} launch at {NAT_DIV}, "
        f"exact vs long_division_ref on the prove's inputs; accepted, a wrong witness "
        f"rejected; h(s) t(s) = ell(s) r(s) - o(s) on the host at a random s")
    return counts


def dense_card_vs_cpu(dev, spec) -> None:
    """Setup and prove at m = 2^4 in both domains, on the card and on the CPU
    plain versions from the same seeds: keys and proofs equal."""
    from myzkp_tpu_torch.snark import pinocchio as pin

    for domain in ("rou", "natural"):
        runs = []
        for d in (dev, torch.device("cpu")):
            qap, _, asg = dense_case(spec, 1 << LOG_M_CMP, domain, d)
            pk, vk = pin.setup(qap, random.Random(DENSE_SEED + 20))
            runs.append((pin.prove(asg, pk, qap, random.Random(DENSE_SEED + 21)), vk))
        if runs[0] != runs[1] or not pin.verify(*runs[0]):
            raise AssertionError(f"dense {domain} 2^{LOG_M_CMP}: the card's key or proof "
                                 f"differs from the CPU's, or was rejected")
    log(f"# dense m = 2^{LOG_M_CMP}, both domains: the card's verification key and proof "
        f"equal the CPU plain versions' point for point, same seeds; accepted")


def tutorials_and_pairing() -> None:
    """The GT pairing against its pure-Python loop and bilinear; the two
    tutorial ladders' protocols and attacks as tests/test_tutorial_protocols.py
    expects them (host only)."""
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.protocols import tutorial_single_poly as tsp
    from myzkp_tpu_torch.protocols import tutorial_snark as ts
    from myzkp_tpu_torch.utils import hostpoly as hp

    R = bn254.R
    rng = random.Random(DENSE_SEED + 30)
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    P, Q = bn254.g1_generator() * a, bn254.g2_generator() * b
    e, native_s = timed(lambda: bn254.optimal_ate_pairing(P, Q))
    ref, ref_s = timed(lambda: bn254.optimal_ate_pairing_ref(P, Q))
    if e != ref:
        raise AssertionError("optimal_ate_pairing differs from optimal_ate_pairing_ref")
    if e != bn254.optimal_ate_pairing(bn254.g1_generator(), bn254.g2_generator()) ** (a * b):
        raise AssertionError("e([a]P, [b]Q) != e(P, Q)^(ab)")
    log(f"# pairing: the C++ engine's e([a]P, [b]Q) == the pure-Python loop's "
        f"({native_s * 1e3:.1f} ms against {ref_s:.3f} s), == e(P, Q)^(ab)")

    roots = [1, 2, 3, 4, 5]
    pR, tR = hp.from_monomials([1, 2, 3], R), hp.from_monomials([1, 2], R)
    pS, tS = tsp.signed_from_monomials([1, 2, 3]), tsp.signed_from_monomials([1, 2])
    vf2, vf3 = tsp.Verifier2(tR, R, rng=random.Random(0)), tsp.Verifier3(tS, R, 5,
                                                                         rng=random.Random(0))
    pk6, vk6 = tsp.setup6(tR, 3, rng=random.Random(0))
    expect = {
        "p1 naive": tsp.naive_protocol(
            tsp.Prover1(hp.from_monomials(roots, 31), hp.from_monomials(roots[:3], 31), 31),
            tsp.Verifier1(roots[:3], 31)),
        "p2 honest": tsp.schwartz_zippel_protocol(tsp.Prover2(pR, tR, R), vf2),
        "p2 attack": tsp.malicious_schwartz_zippel_protocol(
            tsp.MaliciousProver2(tR, R, rng=random.Random(1)), vf2),
        "p3 honest": tsp.discrete_log_protocol(tsp.Prover3(pS, tS, R), vf3),
        "p3 attack": tsp.malicious_discrete_log_protocol(
            tsp.MaliciousProver3(tS, R, rng=random.Random(1)), vf3),
        "p4": tsp.knowledge_of_exponent_protocol(
            tsp.Prover4(pS, tS, R), tsp.Verifier4(tS, R, 5, rng=random.Random(0))),
        "p5": tsp.zk_protocol(tsp.Prover5(pS, tS, R, rng=random.Random(2)),
                              tsp.Verifier5(tS, R, 5, rng=random.Random(3))),
        "p6": tsp.verify6(tsp.prove6(pR, tR, pk6, rng=random.Random(1)), vk6),
    }
    left = [[0, 0, 1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0, 1, 0]]
    right = [[0, 0, 0, 1, 0, 0, 0, 0], [0, 0, 0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 0, 0, 0, 1]]
    outm = [[0, 0, 0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 0, 0, 1], [0, 1, 0, 0, 0, 0, 0, 0]]
    wit, wrong = [1, 210, 2, 3, 5, 7, 6, 35], [1, 210, 2, 3, 5, 7, 6, 36]
    v_ell, v_r, v_o = wit, [1] * 8, [1, 6, 0, 0, 0, 0, 2, 5]
    q = ts.HostQAP.from_r1cs(left, right, outm)
    attack = lambda pk: ts.inconsistent_variable_attack(pk, q, v_ell, v_r, v_o)
    pk1, vk1 = ts.setup1(q, rng=random.Random(7))
    pk2, vk2 = ts.setup2(q, rng=random.Random(5))
    pk3, vk3 = ts.setup3(q, rng=random.Random(6))
    r8 = random.Random(8)
    pk4, vk4 = ts.setup4(q, rng=r8)
    pk5, vk5 = ts.setup5(q, rng=r8)
    expect.update({
        "snark p1 honest": ts.verify1(ts.prove1(pk1, q, wit), vk1),
        "snark p1 wrong witness": not ts.verify1(ts.prove1(pk1, q, wrong), vk1),
        "snark p2 honest": ts.verify2(ts.prove2(pk2, q, wit), vk2),
        "snark p2 wrong witness": not ts.verify2(ts.prove2(pk2, q, wrong), vk2),
        "snark p2 attack succeeds": ts.verify2(attack(pk2), vk2),
        "snark p3 honest": ts.verify3(ts.prove3(pk3, q, wit), vk3),
        "snark p3 attack fails": not ts.verify3(attack(pk3), vk3),
        "snark p4 honest": ts.verify4(ts.prove4(pk4, q, wit), vk4),
        "snark p5 honest": ts.verify5(ts.prove5(pk5, q, wit), vk5),
        "snark p5 attack fails": not ts.verify5(attack(pk5), vk5),
    })
    failed = [k for k, v in expect.items() if not v]
    if failed:
        raise AssertionError(f"tutorial ladders: {failed} not as the reference's tests expect")
    log(f"# tutorials: {len(expect)} checks of both ladders as tests/test_tutorial_protocols.py "
        f"expects them (honest accepted, wrong witnesses rejected, the P2 attacks succeed, "
        f"the P3 / P5 checksums catch theirs)")


def utilities(dev, spec, smi: str, rou: tuple, out: dict) -> None:
    """serialize, checkpoint, the stage spans and the two module entry points."""
    import os
    import tempfile

    from myzkp_tpu_torch.curves import bn254, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.snark import cli as snark_cli
    from myzkp_tpu_torch.snark import pinocchio as pin
    from myzkp_tpu_torch.utils import checkpoint, serialize
    from myzkp_tpu_torch.utils.metrics import PREFIX

    qap, pk, vk, asg = rou[:4]
    rng = lambda: random.Random(DENSE_SEED + 40)
    with tempfile.TemporaryDirectory() as tmp:
        serialize.save_pinocchio_pk(os.path.join(tmp, "pk.npz"), pk)
        serialize.save_pinocchio_vk(os.path.join(tmp, "vk.json"), vk)
        pk2 = serialize.load_pinocchio_pk(os.path.join(tmp, "pk.npz"), dev)
        vk2 = serialize.load_pinocchio_vk(os.path.join(tmp, "vk.json"))
        if vk2 != vk or not same_keys(pk2, pk) or \
                pin.prove(asg, pk2, qap, rng()) != pin.prove(asg, pk, qap, rng()):
            raise AssertionError("serialize: the reloaded dense keys differ or prove otherwise")

        n, chunk = 1 << LOG_CKPT, 1 << LOG_CKPT_CHUNK
        gen = torch.Generator(device=dev).manual_seed(DENSE_SEED + 41)
        r_spec = bn254.r_spec()
        scalars = lambda: limb.from_mont(r_spec, Fp.random(r_spec, gen, (n,), dev).mont)
        pts, ks = fixed_base.fixed_base_multi("g1", scalars()), scalars()
        F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
        path = os.path.join(tmp, "msm.npz")
        saves, save = [], checkpoint._save_state

        class Stopped(Exception):
            """The stand-in for a job killed after its second chunk."""

        def stop_after_two(p, i, acc):
            save(p, i, acc)
            saves.append(i)
            if len(saves) == 2:
                raise Stopped

        checkpoint._save_state = stop_after_two
        try:
            checkpoint.msm_resumable(F, b3, pts, ks, path, chunk=chunk)
            raise AssertionError("msm_resumable: the stop after 2 chunks did not happen")
        except Stopped:
            pass
        finally:
            checkpoint._save_state = save
        if saves != [1, 2] or not os.path.exists(path):
            raise AssertionError(f"msm_resumable: saves {saves}, checkpoint present "
                                 f"{os.path.exists(path)}")
        got = checkpoint.msm_resumable(F, b3, pts, ks, path, chunk=chunk)
        want = msm.msm(F, b3, pts, ks)
        both = bn254.g1_points_to_host(wst.point_map(lambda a, b: torch.stack([a, b], 1),
                                                     got, want))
        if both[0] != both[1] or os.path.exists(path):
            raise AssertionError("msm_resumable: the resumed sum differs from msm, or the "
                                 "checkpoint file stayed")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pin.prove(asg, pk, qap, rng())
        spans = collections.Counter(e.name()[len(PREFIX):]
                                    for e in prof.profiler.kineto_results.events()
                                    if e.name().startswith(PREFIX))
        if not {"quotient", "host read"} <= set(spans):
            raise AssertionError(f"spans: a profiled dense prove shows only {dict(spans)}")
    log(f"# utilities ({smi}): the 2^{LOG_M_ROU} dense keys saved and reloaded prove the same "
        f"proof; msm_resumable over 2^{LOG_CKPT} points in chunks of 2^{LOG_CKPT_CHUNK}, "
        f"stopped after 2 and resumed, == msm, its file removed; the spans of a "
        f"profiled dense prove: {json.dumps(spans)}")

    for argv, env in ((["myzkp_tpu_torch.snark.cli", str(SNARK_CLI_LOG_M)], {}),
                      (["myzkp_tpu_torch.snark.cli", str(SNARK_CLI_LOG_M), "--mesh", "2"], {}),
                      (["myzkp_tpu_torch.protocols.sumcheck_cli"],
                       {"SUMCHECK_VARS": str(SUMCHECK_CLI_VARS)})):
        res = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                             text=True, env={**os.environ, **env}, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        if res.returncode:
            raise AssertionError(f"python -m {' '.join(argv)}: exit {res.returncode}\n"
                                 f"{res.stdout}{res.stderr[-3000:]}")
        log(f"# python -m {' '.join(argv)} {env or ''}: exit 0: "
            f"{' | '.join(res.stdout.strip().splitlines())}")
    try:
        snark_cli.main(["--g2", "naive", str(SNARK_CLI_LOG_M)])
        raise AssertionError("snark.cli --g2 naive ran")
    except SystemExit as exc:
        if exc.code != 2:
            raise AssertionError(f"snark.cli --g2 naive: exit {exc.code}, expected 2") from exc
    log("# snark.cli --g2 naive: refused (exit 2, the chunked naive G2 ladder is TPU-only)")


def phase_dense(dev, results: dict) -> None:
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.ops import poly

    t_phase = time.perf_counter()
    smi = card()
    spec = bn254.r_spec()
    out = {"card": smi}
    rou = dense_rou(dev, spec, smi, out)
    nat_counts = dense_natural(dev, spec, smi, results, out)
    dense_card_vs_cpu(dev, spec)
    tutorials_and_pairing()
    utilities(dev, spec, smi, rou, out)

    rows, na, bd = NAT_DIV
    rng = np.random.default_rng(DENSE_SEED + 50)
    a = random_fe(rng, rows * na, dev).reshape(16, rows, na)
    b = random_fe(rng, rows * (bd + 1), dev).reshape(16, rows, bd + 1)
    time_cases({"long_division": (
        f"(rows, na, bd) = {NAT_DIV}: h = (ell r - o) / t of the natural-domain prove",
        lambda: poly.long_division_cuda(spec, a, b, bd),
        lambda: poly.long_division_ref(spec, a, b, bd), 3, 1,
        bound(rows * (2 * na + 1) * LIMB_BYTES, rows * (na - bd) * (bd + 1),
              IMAD_PER_DIV))}, results)
    results["long_division"]["launches"] = nat_counts["long_division"]
    # the quotient's na - bd coefficients are solved one after another, each
    # at least one product deep: the depth bound at one product's latency
    lat = results["_k1"]["product_latency_us"]
    depth = (na - bd) * lat * 1e-3
    results["long_division"]["depth_bound_ms"] = depth
    log(f"# long_division {NAT_DIV}: depth bound {na - bd} x one product's latency "
        f"{lat:.4f} us = {depth:.4f} ms (ops bound "
        f"{results['long_division']['bound_ms']:.4f} ms); kernel "
        f"{results['long_division']['ms']:.4f} ms: {100 * depth / results['long_division']['ms']:.1f}% "
        f"of the depth bound")
    plan = poly.long_division_plan(rows, na, bd, 8, dev)
    out["k17_plan"] = plan
    log(f"# long_division {NAT_DIV} plan: {json.dumps(plan)}")
    total = {}
    for c in (rou[4], rou[5], nat_counts):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    for k in results:
        if not k.startswith("_"):
            results[k]["dense_launches"] = total.get(k, 0)
    out["phase_s"] = time.perf_counter() - t_phase
    results["_dense"] = out
    log(f"# dense phase {out['phase_s']:.1f} s")


MESH_SEED = SEED + 160
MESH_RANKS = 4  # a card each on a host of four, else sharing one (gloo, staged)
LOG_M_MESH = 20  # square_chain(2^20): m >= D^2 = 16
# (log2 m, NTT, MSM, MSM at c = 14, sumcheck table, M128 codeword): phase 16's sizes
MESH_LOGS = (LOG_M_MESH, 20, 20, LOG_N_C14, 20, 20)
MESH_TIMEOUT = 600  # seconds a rank waits in a collective before it fails
MERKLE_OPENS = (0, 1, (1 << 19) + 7, (1 << 20) - 1)
# the kernels each mesh prove must launch on every rank: both quotients run
# dist_ntt's 1024-point transforms (K5), Groth16's on the rank's blocks
MESH_MSM_KERNELS = ("mont_mul", "mont_pow", "padd", "pdbl", "bucket_scan_rows", "padd2", "pdbl2",
                    "bucket_scan_rows2", "padd_seg_level", "padd2_seg_level", "gather_planes",
                    "scatter_rows")
MESH_NEED = {"pinocchio": MESH_MSM_KERNELS + ("butterfly",),
             "groth16": MESH_MSM_KERNELS + ("butterfly",)}


def mesh_wrappers() -> list:
    """(owner, wrapper, plain version) of every kernel the mesh path calls;
    each plain version takes its wrapper's arguments (K4's G2 instance
    shares K4's)."""
    from myzkp_tpu_torch.curves import curve_kernels as ck
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk

    curve = ("padd", "pdbl", "padd2", "pdbl2", "padd_mixed", "padd_mixed2", "padd_seg_level",
             "padd2_seg_level", "bucket_scan_rows", "gather_planes", "scatter_rows")
    return ([(limb, "mont_mul", limb.mont_mul_ref), (limb, "pow_const", limb.mont_pow_ref),
             (limb, "add", limb.add_ref), (limb, "sub", limb.sub_ref),
             (nk, "butterfly", nk.butterfly_ref), (nk, "ntt_leaf", nk.ntt_leaf_ref),
             (ck, "bucket_scan_rows2", ck.bucket_scan_rows_ref)]
            + [(ck, k, getattr(ck, k + "_ref")) for k in curve])


def arg_key(x):
    """Shapes, dtypes and host values of nested arguments (a FieldSpec by
    its modulus)."""
    if torch.is_tensor(x):
        return tuple(x.shape), str(x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(arg_key(y) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, arg_key(v)) for k, v in x.items()))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return getattr(x, "p", type(x).__name__)


def copy_args(x):
    """Nested arguments with every tensor copied (layout kept)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(copy_args, x))
    if isinstance(x, (tuple, list)):
        return type(x)(copy_args(y) for y in x)
    if isinstance(x, dict):
        return {k: copy_args(v) for k, v in x.items()}
    return x


def arg_tensors(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list, dict)):
        return [t for e in (x.values() if isinstance(x, dict) else x) for t in arg_tensors(e)]
    return []


class kernel_calls:
    """Within the block, every call of a ``mesh_wrappers`` wrapper that
    launches a kernel counts its launches by kernel, and the first call of
    each (wrapper, argument shapes) keeps a copy of its arguments, made
    before the call (K4 and K16 write into theirs).  ``check`` then runs
    each kept call through the wrapper and its plain version on the card."""

    def __init__(self):
        self.calls, self.launched, self.saved = {}, {}, []

    def __enter__(self):
        from myzkp_tpu_torch import _ext

        for owner, name, ref in mesh_wrappers():
            fn = getattr(owner, name)

            def wrapped(*a, _fn=fn, _ref=ref, _name=name, **k):
                key = (_name, arg_key(a), arg_key(k))
                kept = None if key in self.calls else copy_args((a, k))
                before = dict(_ext.launches)
                out = _fn(*a, **k)
                ran = {n: c - before[n] for n, c in _ext.launches.items() if c > before[n]}
                for n, c in ran.items():
                    self.launched[n] = self.launched.get(n, 0) + c
                if ran and kept is not None:
                    self.calls[key] = (sorted(ran), _fn, _ref, kept)
                return out

            self.saved.append((owner, name, fn))
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def check(self, what: str, launches: dict, seen: set) -> dict:
        """Every launch of the block went through a wrapper (``launches``,
        the block's counts, equal to the wrappers' own); each kept call not
        in ``seen`` (keys checked before, updated) held bit-exact against
        its plain version.  {kernel: [shapes checked, max abs err, rows
        left out as K16's shared targets]}."""
        want = {k: v for k, v in launches.items() if v}
        if self.launched != want:
            raise AssertionError(f"{what}: launches outside the recorded wrappers: "
                                 f"{want} against {self.launched}")
        out = {k: [0, 0, 0] for k in want}
        for key, (kernels, fn, ref, (a, k)) in self.calls.items():
            if key in seen:
                continue
            seen.add(key)
            a1, k1 = copy_args((a, k))
            a2, k2 = copy_args((a, k))
            got, exp = fn(*a1, **k1), ref(*a2, **k2)
            shared = 0
            tgt = (a[2] if len(a) > 2 else k.get("tgt")) if key[0] == "scatter_rows" else None
            if tgt is not None:
                # K16's contract: a row two points target holds 16-byte pieces
                # of either, in no set order (the MSM merge's dummy slots);
                # every other row must agree
                many = torch.bincount(tgt.long(), minlength=a[1].shape[0]) > 1
                shared = int(many.sum())
                a1[1][many] = 0
                a2[1][many] = 0
            err = check_equal(f"{what}: {'+'.join(kernels)} at {key[1]}",
                              arg_tensors(got) + arg_tensors((a1, k1)),
                              arg_tensors(exp) + arg_tensors((a2, k2)))
            for n in kernels:
                out[n][0] += 1
                out[n][1] = max(out[n][1], err)
                out[n][2] += shared
        self.calls.clear()
        return out


def host_ints(p) -> tuple | None:
    """A host point as ints (None for infinity): picklable across ranks."""
    if p.inf:
        return None
    return tuple(tuple(int(c) for c in v.c) if hasattr(v, "c") else int(v) for v in (p.x, p.y))


def random_m128(rng: np.random.Generator, n: int, dev) -> torch.Tensor:
    """n random canonical M128 limb columns (top limb kept below p's)."""
    from myzkp_tpu_torch.fields.spec import M128

    limbs = rng.integers(0, 1 << 16, size=(8, n), dtype=np.int64)
    limbs[7] = rng.integers(0, M128 >> 112, size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def mesh_prove(mesh, name: str, fn) -> tuple:
    """fn() (a mesh prove) on every rank from a barrier, with the launch
    counts and collective traffic set to 0 just before it and read just
    after: (its result, {seconds, peak MiB, launches, traffic})."""
    import torch.distributed as dist
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.parallel import mesh as pm

    dist.barrier(group=mesh.get_group("shard"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    pm.reset_traffic()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stats = {"s": time.perf_counter() - t0,
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "launches": {k: v for k, v in _ext.launches.items() if v},
             "traffic": {k: dict(v) for k, v in pm.traffic.items()}}
    missing = [k for k in MESH_NEED[name] if not stats["launches"].get(k)]
    if missing:
        raise AssertionError(f"mesh {name} prove: {missing} never launched: {stats['launches']}")
    return out, stats


def mesh_snark(mesh, name: str, log_m: int, seed: int, checked: set) -> dict:
    """Setup (every rank, one seed; Groth16's the rank's block of the split
    key), the mesh prove timed, its proof verified on every rank and equal
    on every rank to rank 0's single-rank prove of the same toxic waste and
    seed (Groth16's with the whole key, made on rank 0 for it); the prove
    once more with rank 0's kernel calls held to their plain versions
    (``kernel_calls``; the keys in ``checked`` skipped); the key is freed
    before returning."""
    import torch.distributed as dist
    from myzkp_tpu_torch import _ext
    from myzkp_tpu_torch.curves import bn254
    from myzkp_tpu_torch.parallel import mesh as pm
    from myzkp_tpu_torch.snark import groth16, pinocchio

    spec = bn254.r_spec()
    qap, asg = _square_chain_case(spec, 1 << log_m, pm.mesh_device(mesh))
    t0 = time.perf_counter()
    if name == "pinocchio":
        pk, vk = pinocchio.setup(qap, random.Random(seed))
        prove = lambda mesh_: pinocchio.prove(asg, pk, qap, random.Random(seed + 1), mesh=mesh_)
        single = lambda: prove(None)
        verify = lambda pr: pinocchio.verify(pr, vk)
        points = lambda pr: [getattr(pr, f.name) for f in dataclasses.fields(pr)]
    else:
        pk, vk = groth16.setup(qap, NPUB_G16, random.Random(seed), mesh=mesh)
        public = [int(v) for v in asg[:NPUB_G16].to_int()]
        prove = lambda mesh_: groth16.prove(asg, pk, qap, random.Random(seed + 1), mesh=mesh_)

        def single():
            whole, _ = groth16.setup(qap, NPUB_G16, random.Random(seed))
            return groth16.prove(asg, whole, qap, random.Random(seed + 1))

        verify = lambda pr: groth16.verify(pr, vk, public)
        points = lambda pr: [pr.a, pr.b, pr.c]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    proof, stats = mesh_prove(mesh, name, lambda: prove(mesh))
    stats["setup_s"] = setup_s
    if not verify(proof):
        raise AssertionError(f"mesh {name} 2^{log_m}: verify rejected the proof")
    # the same prove again, untimed, with rank 0's kernel calls recorded:
    # each kernel held to its plain version at every shape the path gave it
    zero = mesh.get_local_rank("shard") == 0
    _ext.reset_launches()
    with kernel_calls() if zero else contextlib.nullcontext() as rec:
        again = prove(mesh)
    if zero:
        stats["plain_check"] = rec.check(f"mesh {name} 2^{log_m}", dict(_ext.launches),
                                         checked)
        del rec
    if [host_ints(p) for p in points(again)] != [host_ints(p) for p in points(proof)]:
        raise AssertionError(f"mesh {name} 2^{log_m}: a second prove differs")
    mine = [host_ints(p) for p in points(proof)]
    single = ([host_ints(p) for p in points(single())]
              if mesh.get_local_rank("shard") == 0 else None)
    every = [None] * mesh.size()
    dist.all_gather_object(every, mine, group=mesh.get_group("shard"))
    if single is not None and any(e != single for e in every):
        raise AssertionError(f"mesh {name} 2^{log_m}: a rank's proof differs from the "
                             f"single-rank prove")
    del pk, vk, qap, asg, proof
    torch.cuda.empty_cache()
    return stats


def mesh_kernels(mesh, logs: tuple) -> dict:
    """dist_ntt, dist_msm (default window and c = 14), the sumcheck tables,
    dist_fri_fold and dist_merkle_tree on every rank, each held on rank 0
    to its single-rank function; returns the seconds of each on this rank."""
    from myzkp_tpu_torch.curves import bn254, fixed_base, msm
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb
    from myzkp_tpu_torch.fields.fp import Fp
    from myzkp_tpu_torch.fields.spec import m128_spec
    from myzkp_tpu_torch.ops import ntt
    from myzkp_tpu_torch.parallel import mesh as pm
    from myzkp_tpu_torch.protocols import sumcheck_tpu
    from myzkp_tpu_torch.stark import fri
    from myzkp_tpu_torch.utils import merkle

    _, log_ntt, log_msm, log_c14, log_table, log_fri = logs
    dev = pm.mesh_device(mesh)
    zero = mesh.get_local_rank("shard") == 0
    rng = np.random.default_rng(MESH_SEED + 2)  # the same inputs on every rank
    spec = bn254.r_spec()
    secs = {}

    def check(name: str, got, want_fn) -> None:
        if zero and not torch.equal(got, want_fn()):
            raise AssertionError(f"{name}: differs from the single-rank function")

    def run(name: str, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    a = random_fe(rng, 1 << log_ntt, dev)
    blk, (n1, n2) = run("dist_ntt", lambda: pm.dist_ntt(spec, pm.ntt_block(a, mesh), mesh))
    check(f"dist_ntt 2^{log_ntt}", pm.dist_ntt_to_natural(spec, blk, n1, n2, mesh),
          lambda: ntt.ntt(Fp(spec, a)).mont)

    F, b3 = bn254.g1_ops(), bn254.g1_b3((), dev)
    pts = fixed_base.fixed_base_multi("g1", random_fe(rng, 1 << log_msm, dev))
    ks = random_fe(rng, 1 << log_msm, dev)
    affine = lambda p: bn254.g1_points_to_host(wst.point_map(lambda c: c[:, None], p))[0]
    for name, n, kw in (("dist_msm", 1 << log_msm, {}), ("dist_msm c=14", 1 << log_c14,
                                                         {"c": 14})):
        sub = wst.point_map(lambda c: pm.shard(c[:, :n], mesh).contiguous(), pts)
        res = run(name, lambda: pm.dist_msm(F, b3, sub, pm.shard(ks[:, :n], mesh).contiguous(),
                                            mesh, **kw))
        if zero and affine(res) != affine(msm.msm(F, b3, wst.point_map(lambda c: c[:, :n], pts),
                                                  ks[:, :n].contiguous(), **kw)):
            raise AssertionError(f"{name} 2^{n.bit_length() - 1}: differs from msm")
    del pts, ks

    table = limb.to_mont(spec, random_fe(rng, 1 << log_table, dev))
    r = limb.to_mont(spec, random_fe(rng, 1, dev))[:, 0]
    blk = pm.shard(table, mesh)
    fold = run("dist_fold_into_half", lambda: pm.dist_fold_into_half(spec, blk, mesh, r))
    check(f"dist_fold_into_half 2^{log_table}", pm.gather(fold, mesh),
          lambda: sumcheck_tpu.fold_into_half(Fp(spec, table), Fp(spec, r[:, None])).mont)
    total = run("dist_table_sum", lambda: pm.dist_table_sum(spec, blk, mesh))
    check(f"dist_table_sum 2^{log_table}", total,
          lambda: sumcheck_tpu.table_sum(Fp(spec, table)).mont)

    s4, n = m128_spec(), 1 << log_fri
    cw = limb.to_mont(s4, random_m128(rng, n, dev))
    omega, offset = ntt.nth_root_of_unity(s4.p, n), 7
    alphas = [int(x) for x in rng.integers(1, 1 << 62, size=2)]
    f1 = run("dist_fri_fold", lambda: pm.dist_fri_fold(s4, pm.shard(cw, mesh), mesh, alphas[0],
                                                      offset, omega))
    f2 = pm.dist_fri_fold(s4, f1, mesh, alphas[1], offset ** 2 % s4.p, omega ** 2 % s4.p)
    one = fri.fold_codeword(s4, cw, alphas[0], offset, omega)
    check(f"dist_fri_fold 2^{log_fri}", pm.gather(f1, mesh), lambda: one)
    check(f"dist_fri_fold 2^{log_fri}, round 2", pm.gather(f2, mesh),
          lambda: fri.fold_codeword(s4, one, alphas[1], offset ** 2 % s4.p, omega ** 2 % s4.p))
    std = limb.from_mont(s4, cw)
    tree = run("dist_merkle_tree", lambda: pm.dist_merkle_tree(s4, pm.shard(std, mesh), mesh))
    paths = [tree.open(i) for i in MERKLE_OPENS if i < n]
    if zero:
        mono = merkle.MerkleTree(limb.to_bytes_batch(s4, std))
        if tree.root != mono.root or paths != [mono.open(i) for i in MERKLE_OPENS if i < n]:
            raise AssertionError(f"dist_merkle_tree 2^{log_fri}: root or a path differs")
    return secs


def mesh_rank(mesh, logs: tuple) -> list:
    """One rank of phase 16: the Pinocchio and Groth16 mesh proves (each
    group's key freed before the next), then the dist_* kernels' checks;
    every rank's figures, gathered on rank 0."""
    import torch.distributed as dist

    checked = set()
    stats = {"pinocchio": mesh_snark(mesh, "pinocchio", logs[0], MESH_SEED, checked),
             "groth16": mesh_snark(mesh, "groth16", logs[0], MESH_SEED + 10, checked),
             "dist_s": mesh_kernels(mesh, logs), "rank": mesh.get_local_rank("shard"),
             "backend": str(dist.get_backend())}
    every = [None] * mesh.size()
    dist.all_gather_object(every, stats, group=mesh.get_group("shard"))
    return every


def mesh_rank_nccl(mesh, log_m: int) -> dict:
    """The D = 1 world: the mesh Pinocchio prove through NCCL's branch of
    the collectives."""
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        raise AssertionError(f"the one-rank world runs {dist.get_backend()}, not nccl")
    return mesh_snark(mesh, "pinocchio", log_m, MESH_SEED + 20, set())


def phase_mesh(dev, results: dict) -> None:
    """Phase 16: the mesh over 4 ranks sharing the card (gloo, staged), and
    once at D = 1 on NCCL."""
    from myzkp_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    smi = card()
    every = pm.run_ranks(mesh_rank, MESH_RANKS, MESH_LOGS, timeout=MESH_TIMEOUT)
    nccl = pm.run_ranks(mesh_rank_nccl, 1, LOG_M_MESH, timeout=MESH_TIMEOUT)
    if every[0]["backend"] == "nccl":
        log(f"# mesh ({smi}): {MESH_RANKS} ranks, a card each, backend nccl")
    else:
        log(f"# mesh ({smi}): {MESH_RANKS} ranks share one card, backend "
            f"{every[0]['backend']}; four ranks on one card give no scaling figure: they take "
            f"turns on its SMs")
    for st in every:
        for name in ("pinocchio", "groth16"):
            s = st[name]
            log(f"# mesh rank {st['rank']} {name} 2^{LOG_M_MESH}: setup {s['setup_s']:.3f} s, "
                f"mesh prove {s['s']:.3f} s, peak {s['peak_mib']:.1f} MiB; launches "
                f"{json.dumps(s['launches'])}; sent {json.dumps(s['traffic'])}")
        log(f"# mesh rank {st['rank']} dist_* seconds: "
            f"{json.dumps({k: round(v, 4) for k, v in st['dist_s'].items()})}")
    log(f"# mesh D = 1 (nccl) pinocchio 2^{LOG_M_MESH}: setup {nccl['setup_s']:.3f} s, mesh "
        f"prove {nccl['s']:.3f} s, peak {nccl['peak_mib']:.1f} MiB, sent "
        f"{json.dumps(nccl['traffic'])}; equal to the single-rank prove, accepted")
    runs = ((f"{MESH_RANKS} ranks pinocchio", every[0]["pinocchio"]),
            (f"{MESH_RANKS} ranks groth16", every[0]["groth16"]), ("D = 1 pinocchio", nccl))
    for what, st in runs:
        log(f"# mesh {what} 2^{LOG_M_MESH}, rank 0's kernels against their plain versions "
            f"at every shape the prove gave them (shapes of an earlier run not again), "
            f"bit-exact: {json.dumps({k: v[0] for k, v in st['plain_check'].items()})}; "
            f"scatter_rows' rows two points target (the merge's dummy slots, no set "
            f"content) left out: {st['plain_check'].get('scatter_rows', [0, 0, 0])[2]}")
        for k, (_, err, _) in st["plain_check"].items():
            results[k]["max_abs_err"] = max(results[k].get("max_abs_err", 0), err)
    log(f"# mesh: every proof equal to the single-rank prove on every rank and accepted; "
        f"dist_ntt, dist_msm (c = 14 too), the sumcheck tables, dist_fri_fold (two rounds) "
        f"and dist_merkle_tree (root, {len(MERKLE_OPENS)} paths) equal to their single-rank "
        f"functions")
    for k in results:
        if not k.startswith("_"):
            for name, key in (("pinocchio", "mesh_launches"), ("groth16", "mesh_g16_launches")):
                results[k][key] = every[0][name]["launches"].get(k, 0)
    out = {"card": smi, "ranks": every, "nccl": nccl, "phase_s": time.perf_counter() - t_phase}
    results["_mesh"] = out
    log(f"# mesh phase {out['phase_s']:.1f} s")


SURFACE_SEED = SEED + 170
LOG_PAIRS = 20  # the pair butterfly's pairs at each width
LOG_SMC = 15  # scalar_mul_const's G1 points
LOG_POW_DYN = 20  # pow_dyn's F_r elements
C_UNSIGNED = 16  # the unsigned MSM's window at 2^20: the signed path's default there
POW_DYN_BITS = 256
HOST_SAMPLE = 64  # outputs of a wide call held to the host's ints
# (kernel, the field's spec function in fields/spec.py, words, bytes an element
# at the interface, multiply-adds a product)
PAIR_WIDTHS = (("butterfly_pair", "bn254_r_spec", 8, LIMB_BYTES, IMAD_PER_MONT),
               ("butterfly_pair_l8", "m128_spec", 4, LIMB_BYTES4, IMAD_PER_MONT4),
               ("butterfly_pair_l4", "m64_spec", 2, LIMB_BYTES2, IMAD_PER_MONT2))
# the kernels the counted run must launch: the pair form at each width, the
# G1 and G2 Pippenger kernels (unsigned digits), K1 (pow_dyn)
SURFACE_NEED = tuple(k for k, *_ in PAIR_WIDTHS) + MSM_KERNELS[2:] + (
    "mont_mul", "padd2", "pdbl2", "bucket_scan_rows2", "padd2_seg_level")


def random_below(rng: np.random.Generator, p: int, L: int, n: int, dev) -> torch.Tensor:
    """n canonical limb columns (L, n) below p: random limbs, the top one
    kept below p's."""
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, p >> (16 * (L - 1)), size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def pair_inputs(spec, words: int, rng, dev) -> tuple:
    """u, v, tw over 2^LOG_PAIRS pairs: every pair of word_edges first (with
    0), each with an edge twiddle, then random values."""
    from myzkp_tpu_torch.fields import limb

    edges = word_edges(spec.p, words) + [0]
    k = len(edges) ** 2
    n = 1 << LOG_PAIRS
    u, v, tw = (random_below(rng, spec.p, spec.L, n, dev) for _ in range(3))
    u[:, :k] = limb.from_int(spec, [x for x in edges for _ in edges], dev)
    v[:, :k] = limb.from_int(spec, [y for _ in edges for y in edges], dev)
    tw[:, :k] = limb.from_int(spec, [edges[int(i)] for i in rng.integers(0, len(edges), k)],
                              dev)
    return u, v, tw, k


def host_butterfly(p: int, L: int, u: int, v: int, w: int, dit: bool) -> tuple:
    rinv = pow(1 << (16 * L), -1, p)
    if dit:
        t = v * w * rinv % p
        return (u + t) % p, (u - t) % p
    return (u + v) % p, (u - v) * w * rinv % p


def check_pairs(spec, u, v, tw, dit: bool, out, k: int, rng) -> int:
    """The pair butterfly's (su, sv) exact against its plain version on the
    card, and the edge pairs plus a random sample against the host."""
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk

    err = check_equal(f"butterfly_pair L = {spec.L} {'dit' if dit else 'dif'}",
                      out, nk.butterfly_pair_ref(spec, u, v, tw, dit))
    idx = torch.cat([torch.arange(k), torch.from_numpy(
        rng.integers(k, u.shape[1], HOST_SAMPLE))]).to(u.device)
    ints = [limb.to_int(spec, x[:, idx]) for x in (u, v, tw, *out)]
    for a, b, w, su, sv in zip(*ints):
        if (int(su), int(sv)) != host_butterfly(spec.p, spec.L, int(a), int(b), int(w), dit):
            raise AssertionError(f"butterfly_pair L = {spec.L}: differs from the host")
    return err


def surface_msms(dev) -> dict:
    """The inputs of phase 17's MSMs: 2^LOG_N G1 points [m_i]G and scalars
    k_i (a zero and duplicates), 2^LOG_N_C14 G2 points, and the goldens."""
    from myzkp_tpu_torch.curves import bn254, fixed_base, msm

    n, n14 = 1 << LOG_N, 1 << LOG_N_C14
    rng = random.Random(SURFACE_SEED)
    ms = [rng.randrange(1, bn254.R) for _ in range(n)]
    ks = [rng.randrange(0, bn254.R) for _ in range(n)]
    ks[0], ks[1], ks[2], ks[3] = 0, 5, 5, bn254.R - 1
    rspec = bn254.r_spec()
    m_limbs, k_limbs = (msm.scalars_from_int(rspec, x, dev) for x in (ms, ks))
    dot = lambda a, b: sum(x * y for x, y in zip(a, b)) % bn254.R
    return {"g1": fixed_base.fixed_base_multi("g1", m_limbs),
            "g2": fixed_base.fixed_base_multi("g2", m_limbs[:, :n14].contiguous()),
            "k": k_limbs, "k14": k_limbs[:, :n14].contiguous(), "ms": ms, "ks": ks,
            "exp": bn254.g1_generator() * dot(ks, ms),
            "exp14": dot(ks[:n14], ms[:n14])}


def phase_surface(dev, results: dict) -> None:
    """Phase 17: the last of the JAX package's surface on the card (K5's pair
    form, unsigned-digit Pippenger with a caller's G, scalar_mul_const,
    pow_dyn, the GT helpers), each driven once with the launch counts set to
    0 just before and read just after, then checked and timed."""
    from myzkp_tpu_torch import _ext, native
    from myzkp_tpu_torch.curves import bn254, msm
    from myzkp_tpu_torch.curves import weierstrass as wst
    from myzkp_tpu_torch.fields import limb, ntt_kernels as nk
    from myzkp_tpu_torch.fields import spec as fspec

    t_phase = time.perf_counter()
    smi = card()
    rng = np.random.default_rng(SURFACE_SEED)
    specs = {k: getattr(fspec, fn)() for k, fn, *_ in PAIR_WIDTHS}
    pairs = {k: pair_inputs(specs[k], words, rng, dev) for k, _, words, *_ in PAIR_WIDTHS}
    inp = surface_msms(dev)
    F1, b31 = bn254.g1_ops(), bn254.g1_b3((), dev)
    F2, b32 = bn254.g2_ops(), bn254.g2_b3((), dev)
    g14 = wst.point_map(lambda a: a[:, :1 << LOG_N_C14].contiguous(), inp["g1"])
    few = wst.point_map(lambda a: a[:, :5].contiguous(), inp["g1"])
    smc_pts = wst.point_map(lambda a: a[:, :1 << LOG_SMC].contiguous(), inp["g1"])
    e254 = (1 << 253) | int.from_bytes(rng.bytes(32), "little") % (1 << 253)
    rspec = bn254.r_spec()
    x_pow = random_below(rng, rspec.p, 16, 1 << LOG_POW_DYN, dev)
    e_bits = torch.from_numpy(rng.integers(0, 2, size=(POW_DYN_BITS, 1 << LOG_POW_DYN),
                                           dtype=np.uint8)).to(dev)
    x_mont = limb.to_mont(rspec, x_pow)

    def drive() -> dict:
        out = {k: (nk.butterfly_pair(specs[k], *pairs[k][:3], False),
                   nk.butterfly_pair(specs[k], *pairs[k][:3], True)) for k in specs}
        out["msm"] = msm.msm_pippenger(F1, b31, inp["g1"], inp["k"], c=C_UNSIGNED,
                                       signed=False)
        out["c14_g1"] = msm.msm_pippenger(F1, b31, g14, inp["k14"], c=14, signed=False)
        out["c14_g2"] = msm.msm_pippenger(F2, b32, inp["g2"], inp["k14"], c=14, signed=False)
        out["c14_g1_G"] = msm.msm_pippenger(F1, b31, g14, inp["k14"], c=14, G=3,
                                            signed=False)
        out["c1"] = msm.msm_pippenger(F1, b31, few, inp["k"][:, :5].contiguous(), c=1)
        out["smc"] = wst.scalar_mul_const(F1, b31, smc_pts, e254)
        out["pow"] = limb.pow_dyn(rspec, x_mont, e_bits)
        return out

    (out, counts), drive_s = timed(lambda: counted(drive))
    missing = [k for k in SURFACE_NEED if not counts.get(k)]
    if missing:
        raise AssertionError(f"surface: {missing} never launched: {counts}")
    log(f"# surface ({smi}): the driven run {drive_s:.3f} s (first calls), launches "
        f"{json.dumps(counts)}")

    # K5's pair form at each width: exact, host sample, timed beside its bound
    for k, _, words, nbytes, imad in PAIR_WIDTHS:
        spec, (u, v, tw, ke) = specs[k], pairs[k]
        n = u.shape[1]
        res = results[k]
        res["max_abs_err"] = 0
        ms = {}
        for dit in (False, True):
            err = check_pairs(spec, u, v, tw, dit, out[k][dit], ke, rng)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            ms[dit] = (graph_time_ms(lambda: nk.butterfly_pair(spec, u, v, tw, dit), 20),
                       cuda_time_ms(lambda: nk.butterfly_pair_ref(spec, u, v, tw, dit), 3))
        bnd = bound(5 * nbytes * n, n, imad)
        res.update(ms=max(m for m, _ in ms.values()), plain_ms=max(p for _, p in ms.values()),
                   library_ms=None, **bnd)
        log(f"# surface {k} (L = {spec.L}) over 2^{LOG_PAIRS} pairs, the first {ke} every "
            f"pair of {words}-word edges and 0: exact against the plain version in both "
            f"modes, the edges and {HOST_SAMPLE} random == host; DIF {ms[False][0]:.4f} ms, "
            f"DIT {ms[True][0]:.4f} ms (graph replay), plain {ms[False][1]:.4f} / "
            f"{ms[True][1]:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")

    # the unsigned MSMs against the host, the signed MSM, and each other
    to_host1 = lambda p: bn254.g1_points_to_host(wst.point_map(lambda a: a[:, None], p))[0]
    to_host2 = lambda p: bn254.g2_points_to_host(wst.point_map(lambda a: a[:, None], p))[0]
    signed = msm.msm_pippenger(F1, b31, inp["g1"], inp["k"], c=C_UNSIGNED)
    g1, g2 = bn254.g1_generator(), bn254.g2_generator()
    checks = {"msm": (to_host1(out["msm"]), inp["exp"]),
              "signed": (to_host1(signed), inp["exp"]),
              "c14_g1": (to_host1(out["c14_g1"]), g1 * inp["exp14"]),
              "c14_g1_G": (to_host1(out["c14_g1_G"]), g1 * inp["exp14"]),
              "c14_g2": (to_host2(out["c14_g2"]), g2 * inp["exp14"]),
              "c1": (to_host1(out["c1"]), g1 * (sum(k * m for k, m in zip(
                  inp["ks"][:5], inp["ms"][:5])) % bn254.R))}
    bad = [name for name, (got, want) in checks.items() if got != want]
    if bad:
        raise AssertionError(f"surface: unsigned MSMs differ from the host: {bad}")
    log(f"# surface msm_pippenger(signed=False): 2^{LOG_N} G1 at c = {C_UNSIGNED} == the "
        f"signed MSM == host [sum k_i m_i mod r]G; c = 14 over 2^{LOG_N_C14} G1 (and with "
        f"G = 3) and G2 == host; c = 1 over 5 points == host")

    # every kernel call of the unsigned MSM held to its plain version at its shapes
    torch.cuda.synchronize()
    _ext.reset_launches()
    with kernel_calls() as calls:
        msm.msm_pippenger(F1, b31, inp["g1"], inp["k"], c=C_UNSIGNED, signed=False)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _ext.launches.items() if v}
    plain = calls.check("surface unsigned msm", launched, set())
    for k, (_, err, _) in plain.items():
        results[k]["max_abs_err"] = max(results[k].get("max_abs_err", 0), err)
    log(f"# surface unsigned msm 2^{LOG_N}: every kernel call held to its plain version "
        f"at its own shapes, bit-exact: {json.dumps({k: v[0] for k, v in plain.items()})}; "
        f"scatter_rows' rows two points target left out: "
        f"{plain.get('scatter_rows', [0, 0, 0])[2]}")

    med_u, ts_u = median_ms(lambda: msm.msm_pippenger(F1, b31, inp["g1"], inp["k"],
                                                      c=C_UNSIGNED, signed=False), 3)
    med_s, ts_s = median_ms(lambda: msm.msm_pippenger(F1, b31, inp["g1"], inp["k"],
                                                      c=C_UNSIGNED), 3)
    log(f"# surface msm 2^{LOG_N} c = {C_UNSIGNED} ({smi}): unsigned median {med_u:.2f} ms of "
        f"{[round(t, 2) for t in ts_u]}, signed {med_s:.2f} ms of {[round(t, 2) for t in ts_s]}")

    # scalar_mul_const and pow_dyn against the host on a sample
    idx = sorted(set(rng.integers(0, 1 << LOG_SMC, HOST_SAMPLE).tolist()) | {0})
    got = bn254.g1_points_to_host(wst.point_map(lambda a: a[:, idx], out["smc"]))
    if got != [g1 * (inp["ms"][i] * e254 % bn254.R) for i in idx]:
        raise AssertionError("surface: scalar_mul_const differs from the host")
    idx = torch.from_numpy(rng.integers(0, 1 << LOG_POW_DYN, HOST_SAMPLE)).to(dev)
    xs = limb.to_int(rspec, x_pow[:, idx])
    ys = limb.to_int(rspec, limb.from_mont(rspec, out["pow"][:, idx]))
    bits = e_bits[:, idx].cpu().numpy()
    es = [sum(int(b) << i for i, b in enumerate(bits[:, j])) for j in range(HOST_SAMPLE)]
    if [int(y) for y in ys] != [pow(int(x), e, rspec.p) for x, e in zip(xs, es)]:
        raise AssertionError("surface: pow_dyn differs from the host")
    smc_ms, _ = median_ms(lambda: wst.scalar_mul_const(F1, b31, smc_pts, e254), 3)
    pow_ms, _ = median_ms(lambda: limb.pow_dyn(rspec, x_mont, e_bits), 3)
    log(f"# surface scalar_mul_const over 2^{LOG_SMC} G1 points, a 254-bit e: "
        f"{len(idx)} sampled == host, median {smc_ms:.2f} ms; pow_dyn over 2^{LOG_POW_DYN} "
        f"F_r elements, {POW_DYN_BITS}-bit exponents: {HOST_SAMPLE} sampled == pow(x, e, r), "
        f"median {pow_ms:.2f} ms")

    # the GT helpers: bilinearity and inverses
    a, b = (int(rng.integers(1, 1 << 62)) for _ in range(2))
    e = native.pairing_coeffs(g1, g2)
    one = [1] + [0] * 11
    ok = (native.pairing_coeffs(g1 * a, g2 * b) == native.gt_pow_coeffs(e, a * b)
          and native.gt_mul_coeffs(native.gt_pow_coeffs(e, a), native.gt_pow_coeffs(e, -a)) == one
          and native.gt_inv_coeffs(e) == native.gt_pow_coeffs(e, -1)
          and native.gt_pow_coeffs(e, 0) == one)
    if not ok:
        raise AssertionError("surface: the GT helpers break bilinearity or inverses")
    log("# surface GT: e(aP, bQ) == e(P, Q)^(ab); e^a e^-a == 1; inv(e) == e^-1")
    for k in results:
        if not k.startswith("_"):
            results[k]["surface_launches"] = counts.get(k, 0)
    results["_surface"] = {"card": smi, "drive_s": drive_s, "launches": counts,
                           "msm_unsigned_ms": med_u, "msm_signed_ms": med_s,
                           "msm_unsigned_reps": ts_u, "msm_signed_reps": ts_s,
                           "scalar_mul_const_ms": smc_ms, "pow_dyn_ms": pow_ms,
                           "plain_check": plain,
                           "phase_s": time.perf_counter() - t_phase}
    log(f"# surface phase {results['_surface']['phase_s']:.1f} s")


SOURCES = {
    "mont_mul": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                 "myzkp_tpu/fields/limb_pallas.py:286"),
    # the reference's pow_const / inv: a lax.scan of mont_mul_pallas steps
    # (myzkp_tpu/fields/limb.py:346-371)
    "mont_pow": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                 "myzkp_tpu/fields/limb_pallas.py:286"),
    "padd": ("myzkp_tpu_torch/csrc/curve.cu",
             "myzkp_tpu/curves/curve_pallas.py:322"),
    "pdbl": ("myzkp_tpu_torch/csrc/curve.cu",
             "myzkp_tpu/curves/curve_pallas.py:340"),
    "bucket_scan_rows": ("myzkp_tpu_torch/csrc/bucket_scan.cu",
                         "myzkp_tpu/curves/curve_pallas.py:425"),
    "butterfly": ("myzkp_tpu_torch/csrc/ntt.cu",
                  "myzkp_tpu/fields/limb_pallas.py:76"),
    "ntt_leaf": ("myzkp_tpu_torch/csrc/ntt.cu",
                 "myzkp_tpu/fields/limb_pallas.py:242"),
    "padd2": ("myzkp_tpu_torch/csrc/curve2.cu",
              "myzkp_tpu/curves/curve_pallas.py:534"),
    "pdbl2": ("myzkp_tpu_torch/csrc/curve2.cu",
              "myzkp_tpu/curves/curve_pallas.py:550"),
    "padd_mixed": ("myzkp_tpu_torch/csrc/curve.cu",
                   "myzkp_tpu/curves/curve_pallas.py:239"),
    "padd_mixed2": ("myzkp_tpu_torch/csrc/curve2.cu",
                    "myzkp_tpu/curves/curve_pallas.py:289"),
    # the reference's G2 scan: K steps of padd2_sel_fused (msm.py:215-280)
    "bucket_scan_rows2": ("myzkp_tpu_torch/csrc/bucket_scan.cu",
                          "myzkp_tpu/curves/curve_pallas.py:542"),
    # one level of the reference's _seg_scan_hs (msm.py:335-357) over K2 / K7
    "padd_seg_level": ("myzkp_tpu_torch/csrc/curve.cu",
                       "myzkp_tpu/curves/curve_pallas.py:322"),
    "padd2_seg_level": ("myzkp_tpu_torch/csrc/curve2.cu",
                        "myzkp_tpu/curves/curve_pallas.py:534"),
    # probe 14's row gather with probe 16's rows -> planes transpose fused in
    "gather_planes": ("myzkp_tpu_torch/csrc/rows.cu", "tools/exp_gather_pallas.py:33"),
    # probe 16's planes -> rows transpose, written at targets
    "scatter_rows": ("myzkp_tpu_torch/csrc/rows.cu", "tools/exp_transpose.py:78"),
    # the four-word (M128) instances, on the STARK's path
    "mont_mul_l8": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                    "myzkp_tpu/fields/limb_pallas.py:286"),
    "mont_pow_l8": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                    "myzkp_tpu/fields/limb_pallas.py:286"),
    "butterfly_l8": ("myzkp_tpu_torch/csrc/ntt.cu", "myzkp_tpu/fields/limb_pallas.py:76"),
    "ntt_leaf_l8": ("myzkp_tpu_torch/csrc/ntt.cu", "myzkp_tpu/fields/limb_pallas.py:242"),
    # the reference's long division, a lax.scan on the device (ops/poly.py:229-261)
    "long_division_l8": ("myzkp_tpu_torch/csrc/poly.cu", "myzkp_tpu/ops/poly.py:230"),
    "long_division": ("myzkp_tpu_torch/csrc/poly.cu", "myzkp_tpu/ops/poly.py:230"),
    # the two-word (M64) instances: K1 on the extension fields' path
    "mont_mul_l4": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                    "myzkp_tpu/fields/limb_pallas.py:286"),
    "mont_pow_l4": ("myzkp_tpu_torch/csrc/mont_mul.cu",
                    "myzkp_tpu/fields/limb_pallas.py:286"),
    # K5's pair form: butterfly_pallas's own contract (DIF and DIT), each width
    "butterfly_pair": ("myzkp_tpu_torch/csrc/ntt.cu", "myzkp_tpu/fields/limb_pallas.py:76"),
    "butterfly_pair_l8": ("myzkp_tpu_torch/csrc/ntt.cu", "myzkp_tpu/fields/limb_pallas.py:76"),
    "butterfly_pair_l4": ("myzkp_tpu_torch/csrc/ntt.cu", "myzkp_tpu/fields/limb_pallas.py:76"),
    # K18: no TPU kernel; the reference's add / sub are plain array code
    **{k + w: ("myzkp_tpu_torch/csrc/addsub.cu",
               "none (myzkp_tpu/fields/limb.py:155 add, :162 sub)")
       for k in ("fe_add", "fe_sub") for w in ("", "_l8", "_l4")},
}


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    sass = phase_build()
    results = {k: {} for k in SOURCES}
    phase_bitcheck(dev, results)
    phase_bitcheck_g2(dev, results)
    phase_bitcheck_rows(dev, results)
    phase_bitcheck_levels(dev, results)
    phase_bitcheck_chains(dev, results)
    phase_bitcheck_fr(dev, results)
    phase_bitcheck_pow(dev, results)
    phase_bitcheck_chain_forms(dev, results)
    phase_addsub(dev, results)
    phase_slice(dev, results)
    results["_chains"] = time_chains(dev, results)
    phase_ntt(dev, results)
    big = phase_shifted_h(dev, LOG_M_BIG)
    small = phase_shifted_h(dev, LOG_M_SMALL)
    for run, need in ((big, ("mont_mul", "ntt_leaf")), (small, ("mont_mul", "butterfly"))):
        if min(run["launches"].get(k, 0) for k in need) < 1:
            raise AssertionError(f"shifted h: a kernel of {need} never launched: "
                                 f"{run['launches']}")
    if small["launches"]["butterfly"] != k5_launches(STOCKHAM_TRANSFORMS):
        raise AssertionError(f"shifted h 2^{LOG_M_SMALL}: {small['launches']['butterfly']} K5 "
                             f"launches, not {k5_launches(STOCKHAM_TRANSFORMS)}")
    results["ntt_leaf"]["launches"] = big["launches"]["ntt_leaf"]
    results["butterfly"]["launches"] = small["launches"]["butterfly"]
    results["_shifted_h"] = {f"2^{LOG_M_BIG}": big, f"2^{LOG_M_SMALL}": small}
    time_ntt_kernels(dev, results)
    results["_k1"] = time_k1(dev, results)
    phase_g2_msm(dev, results)
    phase_pinocchio(dev, results)
    time_g2_kernels(dev, results)
    phase_mixed_add(dev, results)
    phase_groth16(dev, results)
    srs, s = phase_kzg(dev, results)
    phase_sumcheck(dev, results, srs, s)
    del srs
    phase_stark(dev, results)
    phase_das(dev, results, sass)
    phase_dense(dev, results)
    phase_mesh(dev, results)
    phase_surface(dev, results)
    keys = ("launches", "kzg_launches", "sumcheck_launches", "stark_launches",
            "das_launches", "dense_launches", "mesh_launches", "mesh_g16_launches",
            "surface_launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("depth_bound_ms", "hash_batch_launches")  # where a kernel has them
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], **{key: results[k][key] for key in keys},
                **{key: results[k][key] for key in extra if key in results[k]}}
               for k in SOURCES]
    log(f"# addsub {json.dumps(results['_addsub'])}")
    log(f"# msm {json.dumps(results['_msm'])}")
    log(f"# ntt {json.dumps(results['_ntt'])}")
    log(f"# k5 {json.dumps(results['_k5'])}")
    log(f"# shifted_h {json.dumps(results['_shifted_h'])}")
    log(f"# g2_msm {json.dumps(results['_g2_msm'])}")
    log(f"# pinocchio {json.dumps(results['_pinocchio'])}")
    log(f"# mixed_add {json.dumps(results['_mixed_add'])}")
    log(f"# groth16 {json.dumps(results['_groth16'])}")
    log(f"# kzg {json.dumps(results['_kzg'])}")
    log(f"# sumcheck {json.dumps(results['_sumcheck'])}")
    log(f"# stark {json.dumps(results['_stark'])}")
    log(f"# das {json.dumps(results['_das'])}")
    log(f"# dense {json.dumps(results['_dense'])}")
    log(f"# mesh {json.dumps(results['_mesh'])}")
    log(f"# surface {json.dumps(results['_surface'])}")
    log(f"# probe13 {json.dumps(results['_probe13'])}")
    log(f"# scan_parent_path {json.dumps(results['_scan_parent_path'])}")
    log(f"# rows {json.dumps(results['_rows'])}")
    log(f"# padd_lanes {json.dumps(results['_padd_lanes'])}")
    log(f"# levels_all_adds {json.dumps(results['_levels_all_adds'])}")

    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
