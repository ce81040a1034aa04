#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``slate_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Device and toolchain: the card's name and power limit, torch and
   CUDA versions, ``nvcc --version``; builds the kernels of
   ``slate_tpu_torch/csrc`` (one ``nvcc`` per source, all at once) and
   prints the build time and ``ptxas`` report.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and at small ragged shapes: relative error
   against the stated tolerance, then, at the main-path shape, the
   kernel's time, the plain version's time, the ``torch.linalg`` call's
   time (CUDA events, median of 7 runs after a warm-up) and the least
   time the card could take (FP32 operations or bytes). K1 at nb = 1024,
   512, 256, 200, 65, 32 and 1; K2 at B = [15360, 1024] and [300, 200],
   unit and not, and [1024, 1024], timed at the largest and smallest
   ``posv`` panel heights (15360, 1024) beside ``solve_triangular``, and
   at 3r's shapes, [32, 32] (pbtrf) and [3584, 512] (hegv's potrf of B),
   unit and not; K3 at B = [1024, 8] and [256, 8] (its callers'
   real columns: posv, gesv, gesv_nopiv, gels LQ; hesv), [1024, 1024]
   and [200, 37], unit and not, timed at the first three beside
   ``solve_triangular``, and at 3r's shapes, [32, 8] (pbtrs, tbsm) and
   [512, 4096] (hegst's block rows), unit and not. K1 over stacks
   (the batched drivers' diagonal blocks in one launch): [5, nb, nb] at
   nb = 1024, 256, 200, 65 and 1, and [64, 256, 256] and [1024, 128,
   128] (3y's stacks), each member bit for bit its single-tile launch,
   the last two timed beside its plain version over the stack and
   ``cholesky_ex`` over the stack.
2b. The LU panel kernels (K4 ``panel_plu``, K5 ``panel_fold`` /
   ``panel_unfold``) against their plain versions on the card: K4 on a
   folded [8, 1024, 2048] panel at blocks 0 and 7 with 3000 rows already
   inactive, the same shape block 0 on a tie, a NaN, a zero-column and a
   half-inactive panel, flat at h=7424 and h=384, blocks 0 and 1 of the
   flat branch's transposed [1, 256, 7424] panel, and through
   ``plu_subpanel(fold=True)`` at h=16384 (pivots, mask and ``info``
   equal, values bit for bit); K5 bitwise against
   ``permute().contiguous()`` at its callers' shapes, the flat branch's
   whole [8448, 256] panel window there and back, and ``unfold_panel``
   and the back ``transpose_tiled`` into a window of a wider matrix in
   place (the rest of it bit for bit unchanged), the forms the LU driver
   runs and the ones timed. Times as in 2; the library call is
   ``torch.linalg.lu_factor`` on the [h, 128] subpanel for K4 and the
   ``permute().contiguous()`` copy for K5.
2c. The QR and unpivoted-LU kernels against their plain versions on the
   card: K6 ``panel_qr`` at [16384, 128] from d0=0, [13312, 128] from
   d0=896 (the last subpanel of the last ``geqrf`` panel) and [384, 128]
   from d0=128, each a column window of a wider matrix (rows above d0
   bitwise unchanged), and twice on one [16384, 128] panel (equal
   bits); K7 ``lu_nopiv_tile`` at [1024, 1024], [200, 200]
   and [65, 65], and at [200, 200] with one exact zero pivot (``info``
   equal). Times as in 2; the library calls are
   ``torch.geqrf`` on the same [h, 128] block and
   ``torch.linalg.lu_factor(pivot=False)`` on the tile.
3. The main path: ``posv`` at f32, n=16384, nb=1024 on ``Grid(1, 1)``
   with A = G·Gᵀ/n + I (built with the port's ``gemm``) and 8
   right-hand sides; checks ``info == 0``, the residual bound, and that
   each kernel was launched on this path; prints ``potrf``/``posv``
   times, the peak memory of ``posv``, and where one ``posv``'s device
   time goes under ``torch.profiler``.
3b. The LU main path: ``gesv`` at f32, n=16384, nb=1024, 8 right-hand
   sides, on a seeded Gaussian A (the pivoting-by-index fast path with
   the folded panel layout); checks ``info == 0``, the residual and
   ‖P·A − L·U‖ bounds, max|L| ≤ 1 + 1e-5 and the exact launch counts;
   prints ``getrf``/``gesv`` times, the peak memory of ``gesv`` and its
   ``torch.profiler`` breakdown.
3c. The flat branch: ``gesv`` at n=8448, nb=256 (every panel window
   height is 256 mod 1024), the same checks and its launch counts (one
   ``transpose_tiled`` each way a panel, K4 on each 128-row block of the
   transposed panel).
3d. The subpanel entry ``plu_panel(fold=True)`` at h=16384, the path of
   the folded subpanel kernel and its two transposes.
3e. ``geqrf`` at f32, m=16384, n=4096, nb=1024 on a seeded Gaussian A
   (the fast path, K6 on every subpanel): ‖A − Q·R‖_F/‖A‖_F and
   ‖Q₁ᵀQ₁ − I‖_F/n within 10·m·2⁻²⁴ (Q·R and Q₁ formed by ``unmqr``),
   exact launch counts; ``geqrf_ms``, GFLOP/s at 2mn² − 2n³/3, peak
   memory and the ``torch.profiler`` breakdown.
3f. ``gels`` at the same shape with 8 right-hand sides: the Householder
   route on a consistent B = A·X₀ (‖X − X₀‖/‖X₀‖ ≤ 1e-3) and on a
   Gaussian B (normal-equations residual within 10·m·2⁻²⁴); the default
   route, which takes CholQR for m ≥ 2n; the LQ route at m=4096,
   n=16384; each with its residual, exact launch counts and ``gels_ms``.
3g. ``gesv_nopiv`` at n=16384, nb=1024, 8 right-hand sides, A = G + n·I:
   ``info`` 0, residual within 10·n·2⁻²⁴, ‖A − L·U‖/(n·‖A‖) ≤ 1e-5, exact
   launch counts, ``getrf_nopiv_ms``, ``gesv_nopiv_ms`` and the breakdown.
4. Failure report: a non-SPD matrix whose leading 256×256 block is not
   positive definite gives ``info == 2`` on the card and on the CPU;
   a small SPD solve agrees between the two. LU at n=2048, nb=1024 with
   SLATE_LU_FAST=1 on the card and on the CPU: equal ipiv, LU within
   10·n·2⁻²⁴·max|LU|; a matrix with a zero column gives the same ``info``
   (1) on both.
4c. ``geqrf`` and ``gels`` at [1024, 512], nb=128 on the card (K6) and on
   the CPU (its plain version), the fast path forced: R, the taus and X
   within 1e-5; a zero pivot under ``gesv_nopiv`` gives ``info`` 1 on
   both.

The two-stage eigensolver and SVD slice (f32, ``Grid(1, 1)``):

2d. The bulge chasers K8 (``hb2st_vmem``) and K9 (``tb2bd_vmem``) on the
   card at (n, band) = (8192, 128), (4096, 128) (the shapes of 3h/3j
   and 3i/3k), (2048, 128), (1024, 128) and (600, 32): the kernel's
   spectrum within 10·n·2⁻²⁴·‖A‖₂ of the dense f64 band's and its
   reflectors rebuilding the band within 10·n·2⁻²⁴; up to n=2048 also
   against the plain version on the card: sweep 0's reflectors within 1e-4, d and |e|
   within 5e-2·‖A‖₂, the plain version's spectrum to the same bound. At
   the two small shapes the plain version also runs in f64 on the card
   and in f32 on the CPU, and the distances of d and |e| between them
   are printed. Kernel times (median of 3) at (8192, 128), with the
   time per wave-equivalent (2(n − 2) + T of them) beside the 42.55 µs
   (K8) and 41.53 µs (K9) of their former design of one launch per wave
   (commits 6498b2e and 274cf77, same card type), and at (2048, 128),
   where the plain version is timed once. Each chaser twice on one band
   gives equal bits.
3h. ``heev`` values at n=8192, nb=128, ``MethodEig.TwoStage``, A = (G + Gᵀ)/2:
   λ within 10·n·2⁻²⁴·‖A‖₂ of ``eigvalsh`` in f64; ``hb2st_vmem`` 1 and no
   other kernel; ``heev_vals_ms``, the stage split (he2hb, gather, hb2st,
   sterf), ``eigvalsh`` in f32 as the yardstick, the breakdown.
3i. ``heev`` with vectors at n=4096, nb=512 (re-blocked to 128),
   ``MethodEig.DC``: ‖A·Z − Z·Λ‖_F/‖A‖_F and ‖ZᵀZ − I‖_F/n within
   10·n·2⁻²⁴; ``heev_ms`` with ``stedc``'s share.
3j. ``gesvd`` values at 8192×8192, nb=128, ``MethodSVD.TwoStage``: σ within
   10·n·2⁻²⁴·σ_max of ``svdvals`` in f64; ``tb2bd_vmem`` 1; ``gesvd_vals_ms``,
   the stage split (ge2tb, gather, tb2bd, bdsqr), the breakdown.
3k. ``svd`` at 6144×4096, nb=128: ‖A − U·Σ·Vᵀ‖_F/‖A‖_F and the
   orthogonality of U and V within 10·m·2⁻²⁴; ``tb2bd_vmem`` 1; ``gesvd_ms``.
4d. A NaN makes the two-stage ``heev`` and ``gesvd`` raise ``SlateError`` on
   the card; a zero matrix gives zero λ and σ; card against CPU at n=256,
   nb=32: λ and σ within 10·n·2⁻²⁴ of the largest.

The Aasen and band LU slice (f32, ``Grid(1, 1)``):

2e. The physical-swap panel LU K10 (``panel_plu_pallas``) against its
   plain version on the card at [16128, 256] (the first ``hetrf`` panel),
   [2048, 256] (a later one) and [300, 128], bit for bit, and on a
   [128, 128] panel with an exact tie that the current-position rule
   breaks, a panel with a NaN and one with a zero column (pivots,
   ``info`` and the NaN pattern equal, values within atol 1e-4); the rank-k
   tail K11 (``rank_k_tail_pallas``) at [32, 96]·[96, 96] (the ``gbtrf``
   trailing update), [4096, 64]·[64, 4096] and a ragged [70, 1]·[1, 130]
   within 1e-5. Times as in 2 at the path shapes; the library calls are
   ``torch.linalg.lu_factor`` (cuSOLVER) on the same panel and ``addmm``
   with TF32 off; K11 at both of its timed shapes beside ``addmm`` and
   an empty kernel (one CTA of 32 threads, built here by ``nvcc``) in
   the same harness, the floor any launch pays.
3l. ``hesv`` at f32, n=16384, nb=256, 8 right-hand sides, A = (G + Gᵀ)/2:
   ``info`` 0, ‖A·X − B‖/(‖A‖·‖X‖) within 10·n·2⁻²⁴, ‖P·A·Pᵀ − L·T·Lᵀ‖_F/
   ‖A‖_F from the loop's T blocks within 10·n·2⁻²⁴, exact launch counts
   (K10 on the 63 live panels, K3 on the 64 tiles of the L solve);
   ``hetrf_ms``, ``hesv_ms``, the stage split, peak memory, the breakdown,
   and ``torch.linalg.ldl_factor_ex`` + ``ldl_solve`` in f32 as the
   yardstick (``torch.linalg.solve`` where CUDA has no LDLᵀ).
3m. ``gbsv`` at f32, n=16384, kl = ku = 32 (storage nb=256, band block
   96), 8 right-hand sides, a Gaussian band without a diagonal boost:
   ``info`` 0, the residual within 10·n·2⁻²⁴, K11 once per panel (171);
   ``gbtrf_ms``, ``gbsv_ms`` and the breakdown.
4e. A singular symmetric matrix (a zero row and column) gives the same
   ``info`` from ``hetrf`` on the card and on the CPU; ``hesv`` and
   ``gbsv`` at n=512 agree between the two (equal pivots, X within the
   forward error bound n·2⁻²⁴·κ(A)).

The mixed-precision slice (``Grid(1, 1)``):

2e. (extended) K11 at each precision tier (``mxu_bf16``, ``bf16_3x``,
   ``bf16_6x``) at its three shapes against its plain version, and as a
   pure product against the f64 one within (TIER_EPS + k·2⁻²⁴)·|A|·|B|
   elementwise (mxu_bf16: 2·2⁻⁸ + 2⁻¹⁶ for its two rounded operands);
   its time at the two timed shapes beside ``tier_addmm`` at that tier.
2f. The tier products at [15360, 1024]·[1024, 15360]: ``tier_addmm_``
   at each tier beside the FP32 ``addmm``, the max error relative to
   |A|·|B| against f64, and at k = 1 each tier within its per-product
   bound.
3n. ``gesv_mixed`` f32 at the JAX bench's ``gesv_mixed_3x_16k`` (n=16384,
   nb=1024, A = 0.01·G + √n·I, nrhs=1024), ``posv_mixed`` f32 on phase
   3's matrix (nrhs=8), both at f64 (nrhs=8) and both GMRES-IR forms at
   f64 (nrhs=1): ``iters``, time, backward error, no fallback, exact
   launch counts (K1 16, K2 15 or K4 128, K5 16 + 16 per factorization,
   K3 16 per ``potrs``/``getrs`` call, counted by wrapping them), the
   full-precision solve's time; getrf and potrf alone at bf16_3x and
   bf16_6x; one f64 residual gemm and the breakdown of an f64
   ``gesv_mixed``.
3o. ``norm`` of each kind on a general, a Lower Hermitian (junk above
   the diagonal) and a triangular matrix at n=16384 against torch f64
   within n·2⁻²⁴; ``potrf``/``getrf(health=True)`` growth within
   [1 − 1e-4, 10]× the true rcond from ``torch.linalg.inv`` in f64;
   ``hetrf(health=True)`` at n=4096, nb=256: K10 15, ``info`` 0.
3p. ``getri`` and ``potri`` at n=16384 with LAPACK's ratio
   ‖I − A·X‖₁/(n·‖A‖₁·‖X‖₁·ε) ≤ 30; K3 on trtri's [1024, 16384] identity
   block row beside ``solve_triangular``.
3q. ``potrf`` at n=32768, nb=1024 at bf16_3x and bf16_6x (the JAX
   bench's ``potrf_3x_32k``): GFLOP/s at n³/3, the factors within 1e-3.
4f. A non-SPD ``posv_mixed`` gives ``info`` > 0 and takes the fallback;
   a singular ``gesv_mixed`` ``info`` > 0; ``potrf(health=True)`` on a
   non-SPD matrix names the first bad tile and no growth.

The Level-3 BLAS, band BLAS, band Cholesky and hegv slice (f32,
``Grid(1, 1)``):

3r. ``hemm`` and ``symm`` (both sides, both ``uplo``s, junk in the other
   half), ``her2k``, ``syr2k`` and ``trmm`` (both sides, Lower/Upper,
   unit and not) at n=16384, nb=1024 against [16384, 1024] operands:
   ‖C − C64‖_F/‖C64‖_F within 10·k·2⁻²⁴ (k the contraction) of the f64
   product formed on the card and within 16·√k·2⁻²⁴ (a TF32 or bf16
   product, 2⁻¹¹ or coarser, lands above it), no kernel launched, each
   timed beside
   ``torch.matmul`` (TF32 off) on the mirrored dense operands. At 3m's
   band (n=16384, kl = ku = 32, storage nb=256, nrhs=8): ``gbmm`` and
   ``hbmm`` on both sides within 10·(2kd + 1)·2⁻²⁴ of the f64 product;
   ``tbsm`` Left/Right × Lower/Upper and Left Lower with pivots, the
   residual ‖T·X − B‖_F/(‖T‖_F·‖X‖_F) within 10·n·2⁻²⁴ and within 2⁻²⁴
   (a stable FP32 solve gives about 2⁻²⁴/√n, a TF32 or bf16 one 2⁻¹¹/√n
   or more), K3 512 on each Lower Left solve and no kernel on the
   others. ``pbsv`` at n=16384, kd=32 (band block 32), nrhs=8, an SPD
   band by diagonal dominance: ``info`` 0, the residual within
   10·n·2⁻²⁴ and 2⁻²⁴, K1 512, K2 512, K3 512; ``pbtrf_ms``, ``pbsv_ms``
   beside the dense ``cholesky`` + ``cholesky_solve``. ``hegv``
   itype 1, 2, 3 at 3i's shape (n=4096, nb=512, DC heev re-blocked to
   128), A = (G + Gᵀ)/2, B = G₂·G₂ᵀ/n + I (G·Gᵀ + n·I scaled by 1/n, so
   λ_min(B) ≥ 1): λ and ‖R‖_F/‖Z‖_F (R = A·Z − B·Z·Λ, A·B·Z − Z·Λ or
   B·A·Z − Z·Λ) within 10·n·2⁻²⁴·‖A‖₂·κ(B) of the f64 reference formed on
   the card and within √n·2⁻²⁴·‖A‖₂·κ(B) (a TF32 or bf16 solve errs by
   2⁻¹¹·‖A‖₂ or more); K1 8, K2 7, K3 8 (itype 1 only), K8 1.
4g. A band that is not positive definite at band block 22 gives ``pbtrf``
   ``info`` 22 and, with ``health=True``, a report naming tile (21, 21);
   a B that is not positive definite at block column 3 gives ``hegv``
   ``info`` 3 with NaN λ and Z; card and CPU agree.

The LAPACK API, stein and CALU slice (``Grid(1, 1)``):

2g. K12 (``stein``, the batched tridiagonal inverse iteration that stands
   for the JAX package's ``lax.scan``) against its plain version on the
   card at n = k = 1024, f32 and f64, on a random and a clustered
   tridiagonal (relative error within 1e-5); its time at n = k = 8192
   beside the plain version's (one run) and its bound.
3s. (a) The LAPACK shims on numpy input: ``slate_sgesv``, ``slate_sposv``,
   ``slate_spotrf`` + ``slate_spotrs``, ``slate_sgetrf`` + ``slate_sgetrs``
   (the pivot round trip) at n = 16384 (nb 512 by ``_default_nb``),
   ``slate_dgesv`` at 8192, ``slate_sgels`` at 16384×4096, ``slate_sgemm``
   and ``slate_strsm`` at 16384 against [16384, 1024], ``slate_slange``
   of each kind, ``slate_sgesvd('N', 'N')`` at 4096: ``info``, the bounds
   of the routine each wraps, exact launch counts, each shim's ms beside
   the Matrix-API call it wraps. (b) ``heev`` with ``MethodEig.QR`` at
   n = 8192, nb = 128: λ within 10·n·2⁻²⁴·‖A‖₂ of ``eigvalsh`` f64,
   ‖A·Z − Z·Λ‖_F/‖A‖_F and ‖ZᵀZ − I‖_F/n within 10·n·2⁻²⁴, K8 1 and K12
   1, the stage split (stein beside sterf); ``slate_ssyev('N')`` on the
   same matrix. (c) ``gesv`` at n = 32768, nb = 1024 (the fast path, on by
   itself; its first groups' subpanels take the CALU tournament), then
   ``getrf_dense_inplace`` and ``potrf_dense_inplace`` at n = 65536,
   nb = 1024 on a 17.2 GB array: GFLOP/s, the peak memory they add (at
   most a quarter of the array's bytes), exact K4/K5 or K1/K2 counts,
   ‖P·A − L·U‖/(n‖A‖) ≤ 1e-5 and ‖A·X − B‖/(‖A‖·‖X‖) ≤ 10·n·2⁻²⁴.
4h. A singular ``slate_sgesv`` (n = 512, nb = 128, the fast path forced)
   gives the same ``info`` on the card and the CPU; ``slate_zheev`` (the
   complex two-stage eigensolver) raises; ``slate_sgetrs`` with another pivot
   blocking raises; ``plu_panel``'s tournament (h = 18432) on a panel with
   a zero column gives the same pivots, ``info`` and zero multipliers on
   the card and the CPU.

The complex solvers and utils slice (``Grid(1, 1)``):

2h. ``generate_matrix``: every formula and random kind at 4096/256 (the
   structured kinds svd, heev, poev, spd at 2048: their cost is host
   numpy QR) on the card and on the CPU: the uniform and binary random
   kinds and the structured kinds bit for bit equal, randn and the
   formula kinds within 8·2⁻²⁴ of the largest entry; ``randn`` at
   16384/1024 timed beside ``torch.randn`` and its byte bound.
3t. The complex solvers with the caller's TF32 on, complex64 unless
   marked: the port's ``gemm`` at [16384, 16384]·[16384, 1024] within
   16·√k·2⁻²⁴ of the complex128 product formed on the card (beside
   ``torch.matmul`` with TF32 on and off); ``posv``, ``gesv``,
   ``gesv_nopiv`` at n=16384, nb=1024, nrhs=8; ``gels`` at 16384×4096
   (Householder, B = A·X₀, with ‖A − Q·R‖_F/‖A‖_F ≤ 10·m·2⁻²⁴);
   ``hesv`` at 8192/256; ``gbsv`` and ``pbsv`` at 16384 with
   kl = ku = kd = 32; ``hegst`` itype 1 at 4096/512 (‖L·C·Lᴴ − A‖ as the
   residual); ``gesv_mixed`` and ``posv_mixed`` in complex128 at 16384
   (``iters``, no fallback); the shims ``slate_cgesv``, ``slate_zposv``,
   ``slate_cgels`` and ``slate_cgemm`` at 8192. Each path: no kernel
   launched (the counts set to 0 just before it), ``info`` 0, its ms and
   ‖A·X − B‖/(‖A‖·‖X‖) ≤ 10·n·u (u = 2⁻²⁴ complex64, 2⁻⁵³ complex128).
   Every complex64 solve is also held to a second bound of its own
   (``TF32_TIGHT``), which a TF32 result fails: it runs again with the
   port's FP32 pins removed, and that control must land above the bound.
4i. Card = CPU for complex at n=512, nb=128: a non-HPD ``potrf``'s
   ``info`` (3), a singular ``gesv``'s (1); ``unmqr`` with ``Op.Trans``
   raises on both; ``slate_cheev`` and ``slate_cgesvd`` give the CPU's λ
   and σ within 10·n·2⁻²⁴ (4h: ``slate_zheev`` the CPU's λ within
   10·n·2⁻⁵³).

The complex and float64 two-stage slice (``Grid(1, 1)``):

2i. K8 and K9 in float64, complex64 and complex128 (one template each,
   ``csrc/chase_flow.cuh``) against their plain versions on the card at
   (n, band) = (512, 64), 64 being the band ``preferred_eig_band``
   gives these types' main paths, (300, 32) and (512, 128), past their
   shared memory: the spectrum against the dense band's in
   f64/complex128 and the band rebuilt from the packed reflectors (and
   K9's column-0 phase) within 10·n·u; d and |e| within CHASE_DE_TOL·‖A‖₂
   and sweep 0's V, τ within CHASE_SWEEP0_TOL, both scaled by u/2⁻²⁴;
   phase0 equal to the plain version's; d and e real; two runs bit for
   bit equal. Then at n = 2048 and band 64 all of these but the plain
   version's, and each alone timed at the main paths' shape, n = 8192
   (complex128 4096) and band 64, and at band 128, with the bound for its
   type (a complex multiply-add four real ones, FP64 at 34 TFLOP/s).
3u. The two-stage paths with the caller's TF32 on, complex64 unless
   marked: ``heev`` values at 4096/128 (with its breakdown under
   ``torch.profiler``), ``gesvd`` values at 4096², ``heev`` with vectors
   (DC) at 4096/512, ``gesvd`` with U, Vᴴ at 6144×4096, ``hegv`` itype 1–3
   at 4096/512 (3r's bounds, against complex128 references); float64
   ``heev`` and ``gesvd`` values at 4096 by TwoStage (they raised on the
   card before); complex128 ``heev`` with vectors at 2048; ``slate_cheev``,
   ``slate_zheev``, ``slate_cgesvd`` and ``slate_zgesvd`` ('N') at 4096 on
   their default grid (Auto: the library's dense eigensolver and SVD).
   λ and σ in the real dtype within 10·n·u (·‖A‖₂, ·σ_max) of
   ``eigvalsh``/``svdvals`` in complex128/f64 on the card (σ of complex
   matrices from the Gram matrix's eigenvalues); the residuals and
   orthogonality of the vectors within 10·n·u (10·m·u for the SVD).
   ``hb2st_vmem`` 1 a ``heev``/``hegv``, ``tb2bd_vmem`` 1 a ``gesvd``, no
   other kernel (complex ``potrf``, ``hegst`` and the solves are library
   ops), none on the shims. Each complex64 two-stage path also meets
   ``TF32_TIGHT[key]`` and runs again with the FP32 pins removed as the
   control, which must land above it.

The p×q slice (virtual ranks on the one card, ``Grid(p, q)``):

3v. K2 at [16384, 1024] (a p×q panel spans every rank row), K3 on a
   unit [256, 16384] and [1024, 16384] block row of U tiles (gesv 2×4
   and gesv_nopiv 2×2 at step 0), and K10 on gesv's first
   [16384, 256] panel, bit for bit, against their plain versions. Then
   ``posv`` at f32 16384/1024, nrhs=8 on 2×2 and 2×4, ``gesv`` at
   16384/256 on 2×4 (the nb K10 admits) and ``gesv_nopiv`` at 16384/1024
   (A = G + n·I) on 2×2, each at ``Option.PipelineDepth`` 0 and 1 (one
   schedule at every depth): ``info`` 0, the residual within 10·n·2⁻²⁴,
   ‖P·A − L·U‖/(n‖A‖) ≤ 1e-5 and max|L| ≤ 1 + 1e-5, depth 0 and depth 1
   equal bit for bit (X, factors, pivots, info), exact launch counts
   (``pq_counts``), each time
   beside the same call on Grid(1, 1), and ``posv`` on 2×2 and 1×1 and
   ``gesv`` on 2×4 under ``torch.profiler``. ``gemm`` on 2×4 by SUMMA,
   Ring and GemmA at [16384²]·[16384, 1024] beside Grid(1, 1) and
   ``torch.matmul``, held to 3r's bounds. On 2×4 at n = 512, nb = 128, ``gesv`` and ``potrf`` on
   the card against the CPU's plain versions (pivots and info equal,
   factors within 10·n·2⁻²⁴), and a non-SPD ``potrf`` (info 3) and a
   singular ``gesv`` give the same info on both.
3w. p×q least squares and two-stage, each call beside the same call on
   Grid(1, 1) with exact launch counts: f32 ``geqrf`` (|A − QR|/|A| and
   |Q₁ᵀQ₁ − I|/n within 10·m·2⁻²⁴) and ``gels`` by Householder
   (consistent and Gaussian B) and CholQR at 16384×4096, nb 1024,
   nrhs 8, on 2×2 and 2×4 (3f's bounds), the LQ ``gels`` at 4096×16384
   on 2×4; ``heev`` values at 8192 (nb 1024, Auto, which re-tiles to the
   card's eig band on 2×2 and takes the dense route on 1×1) on 2×2 against
   3h's f64 reference, vectors (DC) and ``hegv`` itype 1 at 4096/512 on
   2×2 (residual and orthogonality within 10·n·2⁻²⁴, 3r's hegv bounds);
   ``gesvd`` values at 8192² (nb 128, TwoStage) on 2×4 against 3j's f64
   reference, and with U and Vᵀ at 6144×4096 on 2×2 (10·m·2⁻²⁴);
   ``hemm``/``symm`` both sides, ``trmm`` both sides, ``her2k`` and
   ``syr2k`` at 16384/1024 on 2×4 beside ``torch.matmul``, held to 3r's
   bounds. The T of one panel by the Gram recurrence beside larft's,
   both against the f64 larft; ``geqrf`` on 2×4 and ``heev`` values on
   2×2 under ``torch.profiler``.
3x. p×q inverses, condest, mixed solves and Aasen, each p×q path with
   exact launch counts: ``hesv`` (and ``hetrf``) f32 at 16384/256,
   nrhs 8, on 2×4 beside Grid(1, 1) with the aasen/gbtrf_T/hetrs split
   (``info`` 0, residual and ‖P·A·Pᵀ − L·T·Lᵀ‖_F/‖A‖_F within
   10·n·2⁻²⁴); 3n's mixed solves at 16384 (``posv_mixed`` f32 and f64
   and ``posv_mixed_gmres`` f64 on 2×2 at nb 1024, ``gesv_mixed`` f32
   and ``gesv_mixed_gmres`` f64 on 2×4 at nb 256) held to 3n's limits
   beside the same call on Grid(1, 1); ``getri`` and ``potri`` at 16384
   on 2×2 (3p's ratio ≤ 30); ``potrf``/``getrf(health=True)`` at 16384
   on 2×2, growth / true rcond in [1 − 1e-4, 10]; every generator kind
   at 4096/256 on 2×4 bit for bit the Grid(1, 1) matrix (structured
   kinds at 2048) and ``add``/``scale``/``scale_row_col``/``set_matrix``
   on 2×4 equal to 1×1; complex64 ``hesv`` 8192/256, ``posv`` 8192/1024
   and ``gesv`` 8192/256 on 2×2 (``info`` 0, 10·n·2⁻²⁴, no launch).

3y. The band routines and the band BLAS on p×q grids and serving, each
   p×q call beside the same call on Grid(1, 1), bit for bit (X, the
   factors, pivots, ``info``) and with 1×1's exact launch counts: f32
   ``gbsv`` at 3m's shape on 2×4 (K11 171), ``pbsv`` at 3r's on 2×2 (K1,
   K2, K3 512), ``gbmm``, ``hbmm`` Left and Right, ``tbsm`` Left Lower
   with pivots (K3 512) and Right Upper at 3r's shapes on 2×4 (3r's
   bounds), complex64 ``gbsv`` and ``pbsv`` at 8192 on 2×2 (no kernel,
   10·n·2⁻²⁴). Then the batched drivers in f32: ``posv_batched`` and
   ``gesv_batched`` on [64, 1024, 1024] with 8 right-hand sides (nb 256)
   and on [1024, 256, 256] with one (nb 128), ``batched_potrf`` on the
   first and ``batched_trsm`` on the second: ms and solves/s beside
   ``cholesky_ex`` + ``cholesky_solve``, ``lu_factor_ex`` + ``lu_solve``,
   ``cholesky_ex`` and ``solve_triangular`` on the same stack, and on the
   first stack a loop of Grid(1, 1) ``posv``/``gesv`` at nb 256; every
   ``info`` 0, every member's ‖A·X − B‖/(‖A‖·‖X‖) within 10·n·2⁻²⁴, four
   members within 50·n·2⁻²⁴ of their batch-of-1 calls with equal
   ``perm``, K1 exactly n/nb launches a call whatever the batch. A stack
   of 16 at n = 1024 with a NaN tile, a non-SPD and a singular member:
   their ``info`` the CPU's, every X finite, the others within the
   bound. ``solve_ragged`` on 256 requests of seeded odd orders 97–2039,
   ``posv`` and ``gesv`` alternating, 1–8 right-hand sides (one as a 1-D
   b), on the default bucket table: order kept, buckets as
   ``bucket_for``, x shaped as b, each backward error within
   10·bucket·2⁻²⁴; groups × rungs, wall, requests/s, the wall's share in
   the ``serve.dispatch`` spans and ``serve.padded_waste_frac``; the largest ``posv`` group once more
   under ``nan_tile:seed=5``: exactly one request unhealthy, its
   batchmates within the bound.

Each path of 3–3y runs with the launch counts set to 0 just before it
and read just after. Any failure raises and the script exits non-zero.
Without a CUDA card it exits with code 2 before doing anything. The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N, NB, NRHS = 16384, 1024, 8
FLAT_N, FLAT_NB = 8448, 256   # every LU panel window height ≡ 256 mod 1024
PLU_FLAT_H = 7424             # a K4 flat subpanel height of the 8448 gesv
QR_M, QR_N = 16384, 4096      # the JAX bench's geqrf shape (bench.py:766-791)
# K6's (h, d0): geqrf's first subpanel, one of its later ones, gels' short one
QR_SHAPES = ((QR_M, 0), (QR_M - 3 * NB, NB - 128), (384, 128))
EIG_N, EIG_NB = 8192, 128     # heev2_split_8192 / gesvd2_split_8192 (bench.py:945-1051)
# K8/K9 checks (n, band): the shapes of 3h/3j and 3i/3k, then two small
# ones. The plain version, a task-by-task loop of small torch ops, runs up
# to CHASE_PLAIN_MAX_N: on an H100 machine it takes ~0.8 ms a task for
# K8's and ~1.3 ms for K9's, on the card or on its host CPU alike, so
# ~4 minutes each at n=8192 and 60–80 s at 4096, where it ran until 2i
# and 3u came (2d took 217.6 s). Above it the kernel is held to the
# checks that need no plain version: the spectrum and the band rebuilt
# from its reflectors.
CHASE_SHAPES = ((EIG_N, EIG_NB), (4096, EIG_NB), (2048, EIG_NB),
                (1024, 128), (600, 32))
CHASE_PLAIN_MAX_N = 2048
# K8/K9 vs plain: d and |e|, relative to ‖A‖₂. The reduction is backward
# stable, not forward stable: single entries drift apart along a chain of
# ~n·T f32 reflections (1.7e-2·‖A‖₂ measured for K9 at (600, 32) while
# both spectra agreed to 2e-7; the plain version drifts as far from its
# own f64 result), so this only catches gross faults; the spectra and
# the band rebuilt from the kernel's reflectors are the tight checks.
CHASE_DE_TOL = 5e-2
CHASE_SWEEP0_TOL = 1e-4   # K8/K9 vs plain: sweep 0's V and τ (a short chain)
TOL = 1e-5                # kernel vs plain: relative Frobenius error, FP32
LU_ATOL = 1e-4            # K10 vs plain where not bitwise (pivots, info equal)
FP32_PEAK = 67e12         # H100 SXM, non-tensor FP32 FLOP/s (data sheet)
FP64_PEAK = 34e12         # H100 SXM, non-tensor FP64 FLOP/s (data sheet)
HBM_RATE = 3.35e12        # H100 SXM, bytes/s (data sheet)
REPS = 7
# Device cycles of the sleep queued before each timed run (about 25 ms at
# the H100's 1.98 GHz boost clock): the host queues the timed launches
# while the device sleeps, so the events time the device's work and not
# the host's launch overhead (tens of µs a call from Python).
SLEEP_CYCLES = 50_000_000

# kernel -> (source, TPU function it replaces, path whose launches count)
_PLU = "slate_tpu_torch/csrc/panel_plu.cu"
_TR = "slate_tpu_torch/csrc/panel_transpose.cu"
_JPP = "slate_tpu/internal/panel_plu.py"
KERNELS = {
    "potrf_tile": ("slate_tpu_torch/csrc/potrf_tile.cu",
                   "slate_tpu/internal/pallas_kernels.py:428", "posv"),
    "trsm_right_lower_t": ("slate_tpu_torch/csrc/trsm_lower.cu",
                           "slate_tpu/internal/pallas_kernels.py:613", "posv"),
    "trsm_left_lower": ("slate_tpu_torch/csrc/trsm_left.cu",
                        "slate_tpu/internal/pallas_kernels.py:594", "posv"),
    "plu_call": (_PLU, f"{_JPP}:505", "gesv_flat"),
    "plu_call_folded": (_PLU, f"{_JPP}:483", "plu_panel"),
    "plu_call_folded_block": (_PLU, f"{_JPP}:432", "gesv"),
    "transpose_tiled": (_TR, f"{_JPP}:321", "gesv_flat"),
    "transpose_fold": (_TR, f"{_JPP}:363", "plu_panel"),
    "fold_panel": (_TR, f"{_JPP}:381", "gesv"),
    "unfold_panel": (_TR, f"{_JPP}:401", "gesv"),
    "unfold_transpose": (_TR, f"{_JPP}:419", "plu_panel"),
    "qr_call": ("slate_tpu_torch/csrc/panel_qr.cu",
                "slate_tpu/internal/panel_qr.py:173", "geqrf"),
    "lu_nopiv_tile": ("slate_tpu_torch/csrc/lu_nopiv_tile.cu",
                      "slate_tpu/internal/pallas_kernels.py:442",
                      "gesv_nopiv"),
    "hb2st_vmem": ("slate_tpu_torch/csrc/hb2st_chase.cu",
                   "slate_tpu/internal/band_wave_vmem.py:492", "heev_vals"),
    "tb2bd_vmem": ("slate_tpu_torch/csrc/band_chase.cu",
                   "slate_tpu/internal/band_wave_vmem_bd.py:330",
                   "gesvd_vals"),
    "panel_plu_pallas": ("slate_tpu_torch/csrc/panel_plu_swap.cu",
                         "slate_tpu/internal/pallas_kernels.py:508", "hesv"),
    "rank_k_tail_pallas": ("slate_tpu_torch/csrc/rank_k_tail.cu",
                           "slate_tpu/internal/pallas_kernels.py:644",
                           "gbsv"),
    "stein": ("slate_tpu_torch/csrc/stein_tridiag.cu",
              "slate_tpu/linalg/stein.py:49 (lax.scan)", "heev_qr"),
}
# K8 and K9 a wave-equivalent at (8192, 128) in their former design of one
# launch per wave (commits 6498b2e and 274cf77; NVIDIA H100 80GB HBM3, 700 W)
WAVE_US_BEFORE = {"hb2st": 42.55, "tb2bd": 41.53}
AASEN_NB = 256            # hesv's block: the top of B6's width range
BAND_KL = BAND_KU = 32    # gbsv's band: block 2kl + ku = 96 < 128
PB_KD = 32                # pbsv's band: band block 32, K1/K2/K3 at 32
HEGV_N, HEGV_NB = 4096, 512   # 3i's shape (EigBand 128)


def say(*a):
    print(*a, flush=True)


EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int slate_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_launcher():
    """A launcher of an empty kernel (one CTA of 32 threads), built with
    ``nvcc`` into ``slate_tpu_torch/_build/empty/``: what any launch
    costs in the timing harness."""
    import ctypes
    from slate_tpu_torch.internal import _build
    out = _build.BUILD_DIR / "empty"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_SRC)
    so = out / "libempty.so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                    str(out / "empty.cu")], check=True)
    fn = ctypes.CDLL(str(so)).slate_empty
    fn.argtypes = (ctypes.c_void_p,)
    fn.restype = ctypes.c_int

    def launch():
        if fn(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)):
            raise RuntimeError("empty kernel: launch error")
    return launch


def time_ms(fn, setup=None, reps=REPS) -> float:
    """Median device time of ``reps`` runs after a warm-up, each queued
    behind a device sleep; ``setup`` (restoring an input that ``fn``
    updates in place) runs before each, untimed. A call that the host
    cannot queue within the sleep, or that synchronises, is timed with
    its host work."""
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(flops: float, nbytes: float,
          peak: float = FP32_PEAK) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(x, ref) -> float:
    return float(torch.linalg.norm(x.double() - ref.double())
                 / torch.linalg.norm(ref.double()))


def spd_tile(n, gen):
    g = torch.randn(n, n, generator=gen, device="cuda")
    with _f32():
        return g @ g.T / n + torch.eye(n, device="cuda")


def _f32():
    from slate_tpu_torch.internal.precision import full_f32_matmul
    return full_f32_matmul()


def lower_factor(n, gen, unit=False):
    """Random lower-triangular with bounded condition number."""
    l = torch.tril(torch.randn(n, n, generator=gen, device="cuda")) / n
    l += torch.eye(n, device="cuda")
    if unit:
        l.fill_diagonal_(1.0)
    return l


def phase_toolchain():
    from slate_tpu_torch.internal import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"device: {smi}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say(f"toolchain: torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {nvcc[-1]}")
    t0 = time.perf_counter()
    _build.build()
    say(f"build_s: {time.perf_counter() - t0:.3f}")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"  ptxas[{name}]: {line.strip()}")
    # the FP32 pin restores the caller's TF32 choice
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    with _f32():
        assert not torch.backends.cuda.matmul.allow_tf32, "TF32 not pinned off"
    assert torch.backends.cuda.matmul.allow_tf32, "TF32 setting not restored"
    torch.backends.cuda.matmul.allow_tf32 = prev
    return smi


def spd_stack(batch, n, gen):
    """A stack of SPD tiles G·Gᵀ/n + I on the card."""
    g = torch.randn(batch, n, n, generator=gen, device="cuda")
    with _f32():
        return g @ g.mT / n + torch.eye(n, device="cuda")


def potrf_stack_row(a):
    """K1's times on the stack ``a`` [batch, nb, nb] beside its plain
    version and ``cholesky_ex`` over the stack; bound: batch·nb³/3 FLOP,
    or each member's lower triangle read and its factor written (the
    upper triangle zeroed)."""
    from slate_tpu_torch.internal import kernels as K
    batch, nb = a.shape[0], a.shape[-1]
    return dict(ms=time_ms(lambda: K.potrf_tile(a)),
                plain_ms=time_ms(lambda: K.potrf_tile_plain(a), reps=3),
                library_ms=time_ms(lambda: torch.linalg.cholesky_ex(a)),
                bound=bound(batch * nb ** 3 / 3,
                            batch * (nb * (nb + 1) / 2 + nb * nb) * 4))


def potrf_tile_row(a, plain_reps=REPS):
    """K1's times on the tile ``a`` [nb, nb] beside its plain version and
    ``cholesky``; bound: nb³/3 FLOP, or the lower triangle read and the
    factor written (the upper triangle zeroed)."""
    from slate_tpu_torch.internal import kernels as K
    nb = a.shape[0]
    return dict(ms=time_ms(lambda: K.potrf_tile(a)),
                plain_ms=time_ms(lambda: K.potrf_tile_plain(a),
                                 reps=plain_reps),
                library_ms=time_ms(lambda: torch.linalg.cholesky(a)),
                bound=bound(nb ** 3 / 3, (nb * (nb + 1) / 2 + nb * nb) * 4))


def trsm_left_row(l, b, plain_reps=REPS):
    """K3's times on L [n, n], B [n, m] beside its plain version and
    ``solve_triangular``; bound: n²·m FLOP, or L's lower triangle and B
    read and X written."""
    from slate_tpu_torch.internal import kernels as K
    n, m = b.shape
    return dict(ms=time_ms(lambda: K.trsm_left_lower(l, b)),
                plain_ms=time_ms(lambda: K.trsm_left_lower_plain(l, b),
                                 reps=plain_reps),
                library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                    l, b, upper=False)),
                bound=bound(n * n * m, (n * (n + 1) / 2 + 2 * n * m) * 4))


def lu_nopiv_tile_row(a, plain_reps=REPS):
    """K7's times on the tile ``a`` [nb, nb] beside its plain version and
    ``lu_factor(pivot=False)``; bound: 2nb³/3 FLOP, or the tile read and
    written."""
    from slate_tpu_torch.internal import kernels as K
    nb = a.shape[0]
    return dict(ms=time_ms(lambda: K.lu_nopiv_tile(a)),
                plain_ms=time_ms(lambda: K.lu_nopiv_tile_plain(a),
                                 reps=plain_reps),
                library_ms=lu_nopiv_library_ms(a),
                bound=bound(2 * nb ** 3 / 3, 2 * nb * nb * 4))


def swap_row(a, plain_reps=3):
    """K10's times on the panel ``a`` [h, w] beside its plain version and
    ``lu_factor`` (cuSOLVER) on the same panel; bound: swap_bound."""
    from slate_tpu_torch.internal import kernels as K
    h, w = a.shape
    return dict(ms=time_ms(lambda: K.panel_plu_swap(a)),
                plain_ms=time_ms(lambda: K.panel_plu_swap_plain(a),
                                 reps=plain_reps),
                library_ms=cusolver(lambda: time_ms(
                    lambda: torch.linalg.lu_factor(a))),
                bound=swap_bound(h, w))


def trsm_right_row(l, b, plain_reps=REPS):
    """K2's times on L [n, n], B [m, n] beside its plain version and
    ``solve_triangular``; bound: m·n² FLOP, or L and B read and X
    written."""
    from slate_tpu_torch.internal import kernels as K
    m, n = b.shape
    return dict(ms=time_ms(lambda: K.trsm_right_lower_t(l, b)),
                plain_ms=time_ms(lambda: K.trsm_right_lower_t_plain(l, b),
                                 reps=plain_reps),
                library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                    l.mT, b, upper=True, left=False)),
                bound=bound(m * n * n, (n * n + 2 * m * n) * 4))


def check(name, kernel_fn, plain_fn, label):
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    err = rel_err(out, ref)
    mx = float((out - ref).abs().max())
    ok = bool(torch.isfinite(out).all()) and err <= TOL
    say(f"  {name} {label}: rel_err {err:.3e} (tol {TOL:g}), "
        f"max_abs_err {mx:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    return mx


def phase_kernels():
    from slate_tpu_torch.internal import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    say("kernel checks (kernel vs plain on the card):")
    for nb in (NB, HEGV_NB, AASEN_NB, 200, 65, PB_KD, 1):
        a = spd_tile(nb, gen)
        mx = check("potrf_tile", lambda: K.potrf_tile(a),
                   lambda: K.potrf_tile_plain(a), f"nb={nb}")
        assert float(torch.triu(K.potrf_tile(a), 1).abs().max()) == 0.0
        if nb == NB:
            rows["potrf_tile"] = dict(max_abs_err=mx, **potrf_tile_row(a))

    # K1 over a stack, one launch for the batched drivers' diagonal
    # blocks: against its plain version over the same stack, each member
    # bit for bit its own single-tile launch; timed at the diagonal blocks
    # of 3y's two stacks beside cholesky_ex over the stack
    for batch, nb in ((5, NB), (5, 256), (5, 200), (5, 65), (5, 1),
                      (64, 256), (1024, 128)):
        a = spd_stack(batch, nb, gen)
        l = K.potrf_tile(a)
        mx = check("potrf_tile", lambda: l, lambda: K.potrf_tile_plain(a),
                   f"stack [{batch},{nb},{nb}]")
        for i in (0, batch // 2, batch - 1):
            assert torch.equal(l[i], K.potrf_tile(a[i])), (batch, nb, i)
        if batch > 5:
            r = potrf_stack_row(a)
            rows.setdefault("potrf_tile_stacks", {})[(batch, nb)] = r
            say(f"  potrf_tile stack [{batch},{nb},{nb}]: kernel_ms "
                f"{r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, library_ms "
                f"{r['library_ms']:.4f} (cholesky_ex over the stack), "
                f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}), "
                f"max_abs_err {mx:.3e}")

    for (m, n) in ((N - NB, NB), (300, 200), (PB_KD, PB_KD),
                   (HEGV_N - HEGV_NB, HEGV_NB)):
        for unit in (False, True):
            l = lower_factor(n, gen, unit)
            b = torch.randn(m, n, generator=gen, device="cuda")
            mx = check("trsm_right_lower_t",
                       lambda: K.trsm_right_lower_t(l, b, unit),
                       lambda: K.trsm_right_lower_t_plain(l, b, unit),
                       f"B=[{m},{n}] unit={unit}")
            if (m, n) == (N - NB, NB) and not unit:
                rows["trsm_right_lower_t"] = dict(max_abs_err=mx,
                                                  **trsm_right_row(l, b))
                # the smallest posv panel height beside the largest
                b = torch.randn(NB, NB, generator=gen, device="cuda")
                mx = check("trsm_right_lower_t",
                           lambda: K.trsm_right_lower_t(l, b),
                           lambda: K.trsm_right_lower_t_plain(l, b),
                           f"B=[{NB},{NB}]")
                r = trsm_right_row(l, b, plain_reps=3)
                say(f"  trsm_right_lower_t B=[{NB},{NB}]: kernel_ms "
                    f"{r['ms']:.4f}, library_ms {r['library_ms']:.4f} "
                    f"(solve_triangular), bound_ms {r['bound'][0]:.4f} "
                    f"({r['bound'][1]})")

    # K3 at its callers' shapes (the nrhs = 8 real columns of a block row
    # against a 1024 tile in posv, gesv, gesv_nopiv and gels LQ, a 256
    # tile in hesv), wide and ragged, and 3r's (a band block of pbtrs and
    # tbsm, a block row of hegst); the [NB, NRHS] row is the main path's
    thin = {}
    for (n, m) in ((NB, NRHS), (AASEN_NB, NRHS), (NB, NB), (200, 37),
                   (PB_KD, NRHS), (HEGV_NB, HEGV_N)):
        for unit in (False, True):
            l = lower_factor(n, gen, unit)
            b = torch.randn(n, m, generator=gen, device="cuda")
            mx = check("trsm_left_lower",
                       lambda: K.trsm_left_lower(l, b, unit),
                       lambda: K.trsm_left_lower_plain(l, b, unit),
                       f"B=[{n},{m}] unit={unit}")
            if n in (NB, AASEN_NB) and not unit:
                thin[(n, m)] = dict(max_abs_err=mx, **trsm_left_row(l, b))
    for (n, m), r in thin.items():
        say(f"  trsm_left_lower B=[{n},{m}]: kernel_ms {r['ms']:.4f}, "
            f"plain_ms {r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f}"
            f" (solve_triangular), bound_ms {r['bound'][0]:.6f} "
            f"({r['bound'][1]})")
    rows["trsm_left_lower"] = thin[(NB, NRHS)]
    stacks = rows.pop("potrf_tile_stacks")
    for name, r in rows.items():
        say(f"  {name}: kernel_ms {r['ms']:.4f}, plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f}, "
            f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})")
    rows["potrf_tile"]["stacks"] = {
        f"[{b},{n},{n}]": {k: (r[k] if k != "bound" else r[k][0])
                           for k in ("ms", "plain_ms", "library_ms", "bound")}
        for (b, n), r in stacks.items()}
    return rows


def phase_main_path():
    import slate_tpu_torch as st
    from slate_tpu_torch.internal import kernels as K
    grid = st.Grid(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    G = st.Matrix.from_dense(
        torch.randn(N, N, generator=gen, device="cuda"), nb=NB, grid=grid)
    I = st.Matrix.from_dense(torch.eye(N, device="cuda"), nb=NB, grid=grid)
    C = st.gemm(1.0 / N, G, st.transpose(G), 1.0, I)
    del G, I
    A = st.HermitianMatrix(data=C.data, m=N, n=N, nb=NB, grid=grid)
    del C
    B = st.Matrix.from_dense(
        torch.randn(N, NRHS, generator=gen, device="cuda"), nb=NB, grid=grid)

    st.potrf(A)                         # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.perf_counter()
    X, L, info = st.posv(A, B)
    torch.cuda.synchronize()
    posv_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    t0 = time.perf_counter()
    st.potrf(A)
    torch.cuda.synchronize()
    potrf_ms = (time.perf_counter() - t0) * 1e3

    info = int(info)
    x = X.to_dense()
    a = A.to_dense()
    b = B.to_dense()
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
    limit = 10 * N * 2.0 ** -24
    say(f"main path: posv f32 n={N} nb={NB} nrhs={NRHS} Grid(1,1): "
        f"info {info}, residual {r:.3e} (bound {limit:.3e})")
    say(f"  potrf_ms {potrf_ms:.3f} ({N ** 3 / 3 / potrf_ms / 1e6:.1f} "
        f"GFLOP/s at n^3/3), posv_ms {posv_ms:.3f}, posv peak device "
        f"memory above its inputs {peak_gib:.3f} GiB")
    say(f"  kernels: {json.dumps(launches)}")
    assert info == 0, f"posv info {info}"
    assert tuple(x.shape) == (N, NRHS) and bool(torch.isfinite(x).all())
    assert r <= limit, f"residual {r} above {limit}"
    nt = N // NB
    expect = {**dict.fromkeys(K.LAUNCHES, 0), "potrf_tile": nt,
              "trsm_right_lower_t": nt - 1, "trsm_left_lower": nt}
    assert launches == expect, f"launches {launches}, expected {expect}"
    phase_breakdown("posv", lambda: st.posv(A, B))
    return launches


# ---------------------------------------------------------------------------
# the LU slice
# ---------------------------------------------------------------------------

def plu_bound(h, act):
    """K4's least time for one 128-column block: flops of this mask (a
    multiplier and a rank-1 row update per active row and column) and
    bytes (block and mask read once, written once)."""
    a0 = int((act > 0).sum())
    flops = sum(max(a0 - j - 1, 0) * (1 + 2 * (127 - j)) for j in range(128))
    return bound(flops, (2 * h * 128 + 2 * h) * 4 + 128 * 4)


# the panels K4 is checked and digested on (plu_panel_case)
PLU_KINDS = ("random", "tie", "nan", "zero_column", "inactive")


def plu_panel_case(kind, S, nb, L, seed, device="cuda"):
    """A segmented panel [S, nb, L] and its mask for K4: ``random``
    (Gaussian, 18% of rows inactive), ``tie`` (integers in [-3, 3]:
    equal magnitudes in every column), ``nan`` (one NaN in an active row,
    column 9 of every block), ``zero_column`` (column 3 of every block
    zero: a zero pivot) or ``inactive`` (half the rows inactive, those
    100 times larger: they must neither pivot nor change)."""
    g = torch.Generator().manual_seed(seed)
    h = S * L
    if kind == "tie":
        buf = torch.randint(-3, 4, (S, nb, L), generator=g).float()
    else:
        buf = torch.randn(S, nb, L, generator=g)
    kill = 0.5 if kind == "inactive" else 0.18
    act = (torch.rand(h, generator=g) >= kill).float()
    if kind == "inactive":
        dead = (act == 0).view(S, 1, L)
        buf = torch.where(dead, 100 * buf, buf)
    elif kind == "zero_column":
        buf[:, 3::128, :] = 0.0
    elif kind == "nan":
        r = int(torch.nonzero(act)[h // 3])
        buf[r // L, 9::128, r % L] = float("nan")
    return buf.to(device), act.to(device)


def same_bits(x, y) -> bool:
    """NaN at the same places and every other bit equal."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(
        x.masked_fill(nx, 0).view(torch.int32),
        y.masked_fill(ny, 0).view(torch.int32)))


def check_plu(label, buf, act, blk, name):
    """K4 on copies of (buf, act) against its plain version: equal
    pivots, mask and info, and the values bit for bit (NaN where the
    plain version has NaN); returns the max absolute difference."""
    from slate_tpu_torch.internal import kernels as K
    kb, ka = buf.clone(), act.clone()
    piv, info = K.panel_plu(kb, ka, blk, name=name)
    piv_p, info_p = K.panel_plu_plain(buf, act, blk)   # in place on the inputs
    torch.cuda.synchronize()
    mx = float((kb - buf).abs().nan_to_num(0.0).max())
    bits = same_bits(kb, buf)
    ok = (torch.equal(piv, piv_p) and torch.equal(ka, act)
          and int(info) == int(info_p) and bits)
    say(f"  panel_plu {label}: pivots/mask/info equal "
        f"{torch.equal(piv, piv_p)}/{torch.equal(ka, act)}/"
        f"{int(info) == int(info_p)} (info {int(info)}), values bit for bit "
        f"{bits} (max_abs_err {mx:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"panel_plu {label} disagrees with its plain "
                             "version")
    return mx


def time_plu(buf, act, blk, name):
    """Kernel, plain and lu_factor times of one block factorization; the
    inputs are restored before each run, untimed."""
    from slate_tpu_torch.internal import kernels as K
    S, nb, L = buf.shape
    wb, wa = buf.clone(), act.clone()

    def restore():
        wb.copy_(buf)
        wa.copy_(act)
    sub = K.panel_unfold_plain(buf[:, blk * 128:(blk + 1) * 128, :])
    # the library call runs in cuSOLVER: PyTorch's default picks MAGMA's
    # batched routine for this single tall matrix and prints a warning at
    # every call
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        library_ms = time_ms(lambda: torch.linalg.lu_factor(sub))
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
    return dict(ms=time_ms(lambda: K.panel_plu(wb, wa, blk, name=name),
                           restore),
                plain_ms=time_ms(lambda: K.panel_plu_plain(wb, wa, blk),
                                 restore),
                library_ms=library_ms, bound=plu_bound(S * L, act))


def check_transpose(name, fn, plain, x, into=None):
    """K5 through ``fn`` against its plain version, bitwise; with
    ``into`` = (big, window index) it writes into that window of ``big``
    in place (the LU driver's write-back), and every entry of ``big``
    outside the window must keep its bits. Times the form checked."""
    ref = plain(x)
    if into is None:
        run = lambda: fn(x)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        ok = out.shape == ref.shape and torch.equal(out, ref)
    else:
        big, sl = into
        keep = big.clone()
        run = lambda: fn(x, out=big[sl])  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        ok = (out.data_ptr() == big[sl].data_ptr()
              and torch.equal(big[sl], ref))
        big[sl] = keep[sl]
        ok = ok and torch.equal(big, keep)
        del keep
    where = "" if into is None else " into a window, in place"
    say(f"  {name} {tuple(x.shape)} -> {tuple(out.shape)}{where}: bitwise "
        f"{'equal ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with permute().contiguous()")
    return dict(max_abs_err=0.0, ms=time_ms(run),
                plain_ms=time_ms(lambda: plain(x)),
                library_ms=time_ms(lambda: plain_copy(x, ref).contiguous()),
                bound=bound(0, 2 * x.numel() * 4))


def plain_copy(x, out):
    """The library call K5 is held to: one permute().contiguous() copy
    of x into out's layout."""
    if x.dim() == 2 and out.dim() == 2:
        return x.mT
    if x.dim() == 2:
        S = out.shape[0]
        return x.reshape(S, x.shape[0] // S, x.shape[1]).permute(0, 2, 1)
    return x.permute(0, 2, 1).reshape(out.shape)


def phase_lu_kernels():
    from slate_tpu_torch.internal import kernels as K
    from slate_tpu_torch.internal import panel_plu as pp
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    say("LU panel kernel checks (kernel vs plain on the card):")
    # K4, folded: blocks 0 and 7 of one [8, 1024, 2048] panel
    h = N
    buf = torch.randn(8, NB, h // 8, generator=gen, device="cuda")
    act = torch.ones(h, device="cuda")
    act[torch.randperm(h, generator=gen, device="cuda")[:3000]] = 0.0
    t = time_plu(buf, act, 0, "plu_call_folded_block")
    mx = check_plu("folded [8,1024,2048] block 0", buf, act, 0,
                   "plu_call_folded_block")
    mx = max(mx, check_plu("folded [8,1024,2048] block 7", buf, act, 7,
                           "plu_call_folded_block"))
    rows["plu_call_folded_block"] = dict(max_abs_err=mx, **t)
    del buf
    # the same shape on ties, a NaN, a zero column and half the rows
    # inactive
    for kind in PLU_KINDS[1:]:
        kb, ka = plu_panel_case(kind, 8, NB, h // 8, seed=5)
        check_plu(f"folded [8,1024,2048] block 0, {kind}", kb, ka, 0,
                  "plu_call_folded_block")
    del kb
    # K4 on the flat branch's form: blocks 0 and 1 of a transposed
    # [256, h] panel, in place
    fb = torch.randn(1, FLAT_NB, PLU_FLAT_H, generator=gen, device="cuda")
    fa = torch.ones(PLU_FLAT_H, device="cuda")
    fa[torch.randperm(PLU_FLAT_H, generator=gen, device="cuda")[:999]] = 0.0
    for blk in (0, 1):
        check_plu(f"flat [1,{FLAT_NB},{PLU_FLAT_H}] block {blk}", fb, fa, blk,
                  "plu_call")
    del fb
    # K4, flat: [1, 128, h]
    for hf in (PLU_FLAT_H, 384):
        fb = torch.randn(1, 128, hf, generator=gen, device="cuda")
        fa = torch.ones(hf, device="cuda")
        fa[torch.randperm(hf, generator=gen, device="cuda")[:hf // 7]] = 0.0
        if hf == PLU_FLAT_H:
            t = time_plu(fb, fa, 0, "plu_call")
        mxf = check_plu(f"flat h={hf}", fb, fa, 0, "plu_call")
        if hf == PLU_FLAT_H:
            rows["plu_call"] = dict(max_abs_err=mxf, **t)
        else:
            rows["plu_call"]["max_abs_err"] = max(
                rows["plu_call"]["max_abs_err"], mxf)
    # B11/B8/B14 through plu_subpanel(fold=True) at h=16384, against the
    # same three steps in their plain versions
    sub = torch.randn(h, 128, generator=gen, device="cuda")
    act = torch.ones(h, device="cuda")
    act[torch.randperm(h, generator=gen, device="cuda")[:1000]] = 0.0
    out, piv, act_k, info = pp.plu_subpanel(sub, act, fold=True)
    pF = K.panel_fold_plain(sub, 8)
    act_p = act.clone()
    piv_p, info_p = K.panel_plu_plain(pF, act_p, 0)
    out_p = K.panel_unfold_plain(pF)
    torch.cuda.synchronize()
    mx = float((out - out_p).abs().max())
    ok = (torch.equal(piv, piv_p) and torch.equal(act_k, act_p)
          and int(info) == int(info_p) and torch.equal(out, out_p))
    say(f"  plu_subpanel(fold=True) h={h}: pivots, mask, info and values "
        f"bit for bit (max_abs_err {mx:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("plu_subpanel(fold=True) disagrees with the "
                             "plain versions")
    pF = pp.transpose_fold(sub)
    rows["plu_call_folded"] = dict(max_abs_err=mx,
                                   **time_plu(pF, act, 0, "plu_call_folded"))
    # K5, bitwise; the panels go back into windows of a wider matrix in
    # place, as the LU driver writes them
    a = torch.randn(N + 64, N, generator=gen, device="cuda")
    win = a[64:, :NB]                      # a strided column window
    rows["fold_panel"] = check_transpose(
        "fold_panel", pp.fold_panel, lambda x: K.panel_fold_plain(x, 8), win)
    pcf = pp.fold_panel(win)
    check_transpose("unfold_panel", pp.unfold_panel, K.panel_unfold_plain,
                    pcf)
    rows["unfold_panel"] = check_transpose(
        "unfold_panel", pp.unfold_panel, K.panel_unfold_plain, pcf,
        into=(a, (slice(64, None), slice(NB, 2 * NB))))
    del a, win, pcf
    check_transpose("transpose_tiled", pp.transpose_tiled,
                    lambda x: K.panel_fold_plain(x, 1)[0],
                    torch.randn(FLAT_N, 128, generator=gen, device="cuda"))
    # the flat branch: the whole [8448, 256] panel window there, and back
    # into its window in place
    fl = torch.randn(FLAT_N, FLAT_N, generator=gen, device="cuda")
    fwin = fl[:, FLAT_NB:2 * FLAT_NB]
    rows["transpose_tiled"] = check_transpose(
        "transpose_tiled", pp.transpose_tiled,
        lambda x: K.panel_fold_plain(x, 1)[0], fwin)
    back = check_transpose(
        "transpose_tiled", pp.transpose_tiled,
        lambda x: K.panel_fold_plain(x, 1)[0], K.panel_fold_plain(fwin, 1)[0],
        into=(fl, (slice(None), slice(0, FLAT_NB))))
    say(f"  transpose_tiled [{FLAT_NB}, {FLAT_N}] back into its window: "
        f"kernel_ms {back['ms']:.4f}, plain_ms {back['plain_ms']:.4f}, "
        f"bound_ms {back['bound'][0]:.4f} ({back['bound'][1]})")
    del fl, fwin
    rows["transpose_fold"] = check_transpose(
        "transpose_fold", pp.transpose_fold,
        lambda x: K.panel_fold_plain(x, 8), sub)
    rows["unfold_transpose"] = check_transpose(
        "unfold_transpose", pp.unfold_transpose, K.panel_unfold_plain,
        pp.transpose_fold(sub))
    for name, r in rows.items():
        say(f"  {name}: kernel_ms {r['ms']:.4f}, plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f}, "
            f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})")
    return rows


def check_lu(a, LU, piv, X, b, label, calu=False):
    """info-independent checks of one LU solve on the card: residual,
    ‖P·A − L·U‖ / (n‖A‖) and max|L| (printed only where ``calu``: a
    tournament's |L| may exceed 1, tests/test_getrf.py:225)."""
    from slate_tpu_torch import runtime
    n = a.shape[0]
    lu = LU.to_dense()
    x = X.to_dense()
    perm = torch.from_numpy(runtime.resolve_pivots(piv.cpu().numpy(), n)
                            ).to(a.device)
    l = torch.tril(lu, -1)
    l.diagonal().fill_(1.0)
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
        f = float(torch.linalg.norm(a[perm] - l @ torch.triu(lu))
                  / (n * torch.linalg.norm(a)))
    lmax = float(l.abs().max())
    limit = 10 * n * 2.0 ** -24
    say(f"  {label}: residual {r:.3e} (bound {limit:.3e}), |PA-LU|/(n|A|) "
        f"{f:.3e} (bound 1e-5), max|L| {lmax:.6f} "
        f"({'CALU, no bound' if calu else 'bound 1+1e-5'})")
    assert bool(torch.isfinite(x).all()) and tuple(x.shape) == tuple(b.shape)
    assert r <= limit, f"{label}: residual {r} above {limit}"
    assert f <= 1e-5, f"{label}: |PA-LU| {f} above 1e-5"
    assert calu or lmax <= 1.0 + 1e-5, f"{label}: max|L| {lmax}"


def run_gesv(n, nb, seed, expect_nonzero, label, breakdown=False,
             calu=False):
    """One LU solve path on the card: gesv on a seeded Gaussian A with
    the launch counts set to 0 just before and read just after."""
    import slate_tpu_torch as st
    from slate_tpu_torch.internal import kernels as K
    grid = st.Grid(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    A = st.Matrix.from_dense(a, nb=nb, grid=grid)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    st.gesv(A, B)                      # warm-up: cuSOLVER/cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.perf_counter()
    X, LU, piv, info = st.gesv(A, B)
    torch.cuda.synchronize()
    gesv_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    t0 = time.perf_counter()
    st.getrf(A)
    torch.cuda.synchronize()
    getrf_ms = (time.perf_counter() - t0) * 1e3
    info = int(info)
    say(f"{label}: gesv f32 n={n} nb={nb} nrhs={NRHS} Grid(1,1): info "
        f"{info}")
    say(f"  getrf_ms {getrf_ms:.3f} ({2 * n ** 3 / 3 / getrf_ms / 1e6:.1f} "
        f"GFLOP/s at 2n^3/3), gesv_ms {gesv_ms:.3f}, gesv peak device "
        f"memory above its inputs {peak_gib:.3f} GiB")
    say(f"  kernels: {json.dumps(launches)}")
    assert info == 0, f"gesv info {info}"
    check_lu(a, LU, piv, X, b, label, calu)
    expect = {**dict.fromkeys(K.LAUNCHES, 0), **expect_nonzero}
    assert launches == expect, f"launches {launches}, expected {expect}"
    if breakdown:
        phase_breakdown("gesv", lambda: st.gesv(A, B))
    return launches


def phase_plu_panel():
    """3d: the subpanel entry at h=16384 with the folded layout."""
    from slate_tpu_torch.internal import kernels as K
    from slate_tpu_torch.internal import panel_plu as pp
    gen = torch.Generator(device="cuda").manual_seed(4)
    sub = torch.randn(N, 128, generator=gen, device="cuda")
    act = torch.ones(N, device="cuda")
    K.reset_launches()
    out, piv, act2, info = pp.plu_panel(sub, act, fold=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    say(f"plu_panel(fold=True) h={N}: info {int(info)}, kernels "
        f"{json.dumps(launches)}")
    expect = {**dict.fromkeys(K.LAUNCHES, 0), "transpose_fold": 1,
              "plu_call_folded": 1, "unfold_transpose": 1}
    assert launches == expect, f"launches {launches}, expected {expect}"
    assert int(info) == 0 and int((act2 > 0).sum()) == N - 128
    assert int(torch.unique(piv).numel()) == 128
    return launches


def _category(name: str) -> str:
    if "plu_swap" in name:
        return "physical-swap panel LU kernel (K10)"
    if "rank_k" in name:
        return "rank-k tail kernel (K11)"
    if "getrf" in name or "getf2" in name or "laswp" in name:
        return "cuSOLVER getrf (band windows)"
    if "qr_subpanel" in name:
        return "panel QR kernel (K6)"
    if "Hb2st" in name:  # chase_flow<Hb2st<J>>, csrc/hb2st_chase.cu
        return "hb2st chase kernel (K8)"
    if "Tb2bd" in name:  # chase_flow<Tb2bd<J>>, csrc/band_chase.cu
        return "tb2bd chase kernel (K9)"
    if any(k in name for k in ("geqr", "larf", "orm", "nrm2", "cusolver")):
        return "cuSOLVER panel QR (geqrf)"
    if "gemv" in name:
        return "cuBLAS gemv (larft, small products)"
    if "lu_nopiv_tile" in name:
        return "tile LU kernel (K7)"
    if "plu_block" in name:
        return "panel LU kernel (K4)"
    if "panel_transpose" in name:
        return "panel transposes (K5)"
    if "dataflow_potrf_tile" in name:
        return "potrf_tile kernel (K1)"
    if "dataflow_trsm_right" in name:
        return "right-solve kernel (K2)"
    if "dataflow_trsm_left" in name:
        return "left-solve kernel (K3)"
    if "gemm" in name or "xmma" in name or "cutlass" in name:
        return "cuBLAS gemm (trailing update, trsm update)"
    if "trsm" in name:
        return "cuBLAS trsm (back solve, U-row solves)"
    if "sort" in name.lower():
        return "sort (LU compaction)"
    return "copies and elementwise (layout, guards, padding, gathers)"


def phase_breakdown(label, fn, cpu=True, host_top=0):
    """Where the device time of one call goes: kernel time by category
    from torch.profiler, and the device's busy share of the wall time.
    ``cpu=False`` traces the device alone: a call of tens of thousands
    of small torch ops otherwise spends minutes building its host
    events. ``host_top`` > 0 also prints that many host ops with the
    most self time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cats: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = _category(e.name)
            cats[c] = cats.get(c, 0.0) + e.time_range.elapsed_us()
    busy = sum(cats.values())
    if not busy:
        say("breakdown: the profiler saw no device time: not measured")
        return
    say(f"breakdown of one {label} under torch.profiler: wall_ms "
        f"{wall_us / 1e3:.3f}, device busy_ms {busy / 1e3:.3f} "
        f"(busy share {busy / wall_us:.3f})")
    for c, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        say(f"  {c}: {us / 1e3:.3f} ms ({us / busy:.3f} of device time)")
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        say("  host ops by self time: " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
            for e in ops[:host_top]))


def phase_failure_report():
    import slate_tpu_torch as st
    n, nb = 300, 128
    rng = np.random.default_rng(7)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    xs = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        X, _, info = st.posv(st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
                             st.Matrix.from_dense(b, nb=nb, grid=grid))
        assert int(info) == 0
        xs[dev] = X.to_dense().cpu()
    err = rel_err(xs["cuda"], xs["cpu"])
    say(f"small posv n={n} nb={nb}: card vs CPU rel_err {err:.3e} (tol 1e-4)")
    assert err <= 1e-4
    bad = a.copy()
    bad[200, 200] = -100.0    # leading 128 block SPD, leading 256 block not
    infos = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        _, info = st.potrf(st.HermitianMatrix.from_dense(bad, nb=nb, grid=grid))
        infos[dev] = int(info)
    say(f"failure report: info card {infos['cuda']}, CPU {infos['cpu']}")
    assert infos == {"cuda": 2, "cpu": 2}, infos


def phase_lu_failure_report():
    """LU on the card against the CPU at n=2048, nb=1024 with the fast
    path forced on both (n is below the auto gate): equal ipiv, LU within
    10·n·2⁻²⁴·max|LU| (the panel kernel is bitwise equal to its plain
    version, but cuBLAS and the CPU's BLAS sum the updates in other
    orders, and an f32 LU's distance from the exact factors grows like
    n·ε·max|U| on either side); and a zero column gives the same info,
    1, on both."""
    import slate_tpu_torch as st
    n, nb = 2048, 1024
    rng = np.random.default_rng(9)
    a = rng.standard_normal((n, n)).astype(np.float32)
    os.environ["SLATE_LU_FAST"] = "1"
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            LU, piv, info = st.getrf(st.Matrix.from_dense(
                a, nb=nb, grid=st.Grid(1, 1, device=dev)))
            res[dev] = (LU.to_dense().cpu(), piv.cpu(), int(info))
        diff = float((res["cuda"][0] - res["cpu"][0]).abs().max())
        limit = 10 * n * 2.0 ** -24 * float(res["cpu"][0].abs().max())
        same = torch.equal(res["cuda"][1], res["cpu"][1])
        say(f"small getrf n={n} nb={nb} (SLATE_LU_FAST=1): card vs CPU ipiv "
            f"equal {same}, info {res['cuda'][2]}/{res['cpu'][2]}, LU "
            f"max_abs_diff {diff:.3e} (bound 10*n*2^-24*max|LU| = "
            f"{limit:.3e})")
        assert same and res["cuda"][2] == res["cpu"][2] == 0
        assert diff <= limit
        z = a.copy()
        z[:, 77] = 0.0
        infos = {dev: int(st.getrf(st.Matrix.from_dense(
            z, nb=nb, grid=st.Grid(1, 1, device=dev)))[2])
            for dev in ("cuda", "cpu")}
    finally:
        del os.environ["SLATE_LU_FAST"]
    say(f"LU failure report (zero column): info card {infos['cuda']}, CPU "
        f"{infos['cpu']}")
    assert infos == {"cuda": 1, "cpu": 1}, infos


# ---------------------------------------------------------------------------
# the QR and unpivoted-LU slice
# ---------------------------------------------------------------------------

def qr_bound(hh):
    """K6's least time for one subpanel of hh rows from its diagonal: the
    flops of its column loop (per column, the sums vᵀa_k and the rank-1
    update of the columns right of it) and the bytes (the rows read once
    and written once, tau written)."""
    flops = sum(2 * (hh - j - 1) * (128 - j) + 2 * (hh - j) * (127 - j)
                for j in range(128))
    return bound(flops, (2 * hh * 128 + 128) * 4)


def cusolver(fn):
    """Run a library call with cuSOLVER as PyTorch's linear-algebra
    backend (its default may pick MAGMA for a single matrix and warn)."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return fn()
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def check_qr(h, d0, gen, timing):
    """K6 on a column window of a wider matrix against its plain version:
    the factored window and tau within TOL, everything outside the window
    and above d0 bitwise unchanged."""
    from slate_tpu_torch.internal import kernels as K
    big = torch.randn(h, 3 * 128, generator=gen, device="cuda")
    ref = big.clone()
    win = big[:, 128:256]
    tau = K.panel_qr(win, d0)
    sub_p = ref[:, 128:256].clone()
    tau_p = K.panel_qr_plain(sub_p, d0)
    torch.cuda.synchronize()
    err = max(rel_err(win, sub_p), rel_err(tau, tau_p))
    mx = float((win - sub_p).abs().max())
    kept = (torch.equal(big[:d0], ref[:d0])
            and torch.equal(big[:, :128], ref[:, :128])
            and torch.equal(big[:, 256:], ref[:, 256:]))
    ok = bool(torch.isfinite(win).all()) and err <= TOL and kept
    say(f"  panel_qr [{h},128] d0={d0}: rel_err {err:.3e} (tol {TOL:g}), "
        f"max_abs_err {mx:.3e}, untouched rows and columns equal {kept} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"panel_qr [{h},128] d0={d0} disagrees with "
                             "its plain version")
    if not timing:
        return dict(max_abs_err=mx)
    work = ref.clone()
    ww = work[:, 128:256]

    def restore():
        ww.copy_(ref[:, 128:256])
    block = ref[d0:, 128:256].contiguous()
    return dict(max_abs_err=mx,
                ms=time_ms(lambda: K.panel_qr(ww, d0), restore),
                plain_ms=time_ms(lambda: K.panel_qr_plain(ww, d0), restore),
                library_ms=cusolver(lambda: time_ms(
                    lambda: torch.geqrf(block))),
                bound=qr_bound(h - d0))


def lu_nopiv_library_ms(a):
    """``torch.linalg.lu_factor(pivot=False)``, the same function, where
    this PyTorch build has it on the card; None where it raises."""
    try:
        return time_ms(lambda: torch.linalg.lu_factor(a, pivot=False))
    except RuntimeError as e:
        say(f"  lu_factor(pivot=False) not available: {e}")
        return None


def phase_qr_nopiv_kernels():
    from slate_tpu_torch.internal import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    say("QR and unpivoted-LU kernel checks (kernel vs plain on the card):")
    rows["qr_call"] = check_qr(*QR_SHAPES[0], gen, True)
    for h, d0 in QR_SHAPES[1:]:
        mx = check_qr(h, d0, gen, False)["max_abs_err"]
        rows["qr_call"]["max_abs_err"] = max(rows["qr_call"]["max_abs_err"],
                                             mx)
    # two runs on one window: the same bits (a fixed reduction order)
    a = torch.randn(QR_M, 128, generator=gen, device="cuda")
    x, y = a.clone(), a.clone()
    same = (torch.equal(K.panel_qr(x, 0), K.panel_qr(y, 0))
            and torch.equal(x, y))
    say(f"  panel_qr [{QR_M},128]: two runs bit for bit equal: {same}")
    assert same, "panel_qr does not repeat its bits"
    del a, x, y
    # K7 on G + nb·I at gesv_nopiv's tile, a ragged width and one below a
    # 64-column block; then a zero row and column: one exact zero pivot
    for nb, zero in ((NB, None), (200, None), (65, None), (200, 70)):
        a = torch.randn(nb, nb, generator=gen, device="cuda") \
            + nb * torch.eye(nb, device="cuda")
        if zero is not None:
            a[zero, :] = 0.0
            a[:, zero] = 0.0
        lu, info = K.lu_nopiv_tile(a)
        lu_p, info_p = K.lu_nopiv_tile_plain(a)
        torch.cuda.synchronize()
        err = rel_err(lu, lu_p)
        mx = float((lu - lu_p).abs().max())
        want = 0 if zero is None else 1
        ok = (bool(torch.isfinite(lu).all()) and err <= TOL
              and int(info) == int(info_p) == want)
        say(f"  lu_nopiv_tile nb={nb}{'' if zero is None else ' zero pivot'}: "
            f"rel_err {err:.3e} (tol {TOL:g}), max_abs_err {mx:.3e}, info "
            f"{int(info)}/{int(info_p)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"lu_nopiv_tile nb={nb} disagrees with its "
                                 "plain version")
        if nb == NB:
            rows["lu_nopiv_tile"] = dict(max_abs_err=mx,
                                         **lu_nopiv_tile_row(a))
        else:
            rows["lu_nopiv_tile"]["max_abs_err"] = max(
                rows["lu_nopiv_tile"]["max_abs_err"], mx)
    for name, r in rows.items():
        lib = r["library_ms"]
        say(f"  {name}: kernel_ms {r['ms']:.4f}, plain_ms "
            f"{r['plain_ms']:.4f}, library_ms "
            f"{'null' if lib is None else f'{lib:.4f}'}, bound_ms "
            f"{r['bound'][0]:.4f} ({r['bound'][1]})")
    return rows


def start_path():
    """Reset the peak memory and the launch counts just before a path."""
    from slate_tpu_torch.internal import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    return base, time.perf_counter()


def end_path(base, t0, expect_nonzero):
    """Read the path's time, launch counts and peak memory just after it;
    the counts must be exactly ``expect_nonzero`` and 0 elsewhere."""
    from slate_tpu_torch.internal import kernels as K
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    expect = {**dict.fromkeys(K.LAUNCHES, 0), **expect_nonzero}
    say(f"  kernels: {json.dumps({k: v for k, v in launches.items() if v})}")
    assert launches == expect, f"launches {launches}, expected {expect}"
    return ms, launches, peak_gib


def phase_geqrf():
    """3e: geqrf at the JAX bench's QR shape."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    m, n = QR_M, QR_N
    gen = torch.Generator(device="cuda").manual_seed(6)
    a = torch.randn(m, n, generator=gen, device="cuda")
    A = st.Matrix.from_dense(a, nb=NB, grid=grid)
    st.geqrf(A)                        # warm-up: cuBLAS handles
    base, t0 = start_path()
    QR, T = st.geqrf(A)
    ms, launches, peak_gib = end_path(base, t0, {"qr_call": 32})
    r = torch.triu(QR.to_dense()[:n])
    R0 = st.Matrix.from_dense(torch.cat([r, r.new_zeros(m - n, n)]), nb=NB,
                              grid=grid)
    qr_ = st.unmqr(st.Side.Left, st.Op.NoTrans, QR, T, R0).to_dense()
    I0 = st.Matrix.from_dense(torch.eye(m, n, device="cuda"), nb=NB,
                              grid=grid)
    q1 = st.unmqr(st.Side.Left, st.Op.NoTrans, QR, T, I0).to_dense()
    with _f32():
        rec = float(torch.linalg.norm(a - qr_) / torch.linalg.norm(a))
        orth = float(torch.linalg.norm(q1.T @ q1 - torch.eye(
            n, device="cuda")) / n)
    limit = 10 * m * 2.0 ** -24
    say(f"QR path: geqrf f32 m={m} n={n} nb={NB} Grid(1,1): |A-QR|/|A| "
        f"{rec:.3e}, |Q1^T Q1 - I|/n {orth:.3e} (bound {limit:.3e} each)")
    say(f"  geqrf_ms {ms:.3f} ({(2 * m * n * n - 2 * n ** 3 / 3) / ms / 1e6:.1f}"
        f" GFLOP/s at 2mn^2-2n^3/3), geqrf peak device memory above its "
        f"inputs {peak_gib:.3f} GiB")
    assert bool(torch.isfinite(qr_).all()) and T.shape == (n // NB, NB, NB)
    assert rec <= limit and orth <= limit, (rec, orth)
    phase_breakdown("geqrf", lambda: st.geqrf(A))
    return launches


def normal_residual(a, x, b):
    """‖Aᵀ(A·X − B)‖_F / (‖A‖_F·(‖A‖_F·‖X‖_F + ‖B‖_F))."""
    with _f32():
        an = torch.linalg.norm(a)
        return float(torch.linalg.norm(a.T @ (a @ x - b))
                     / (an * (an * torch.linalg.norm(x)
                              + torch.linalg.norm(b))))


def run_gels(label, A, B, opts, expect_nonzero):
    import slate_tpu_torch as st
    st.gels(A, B, opts)                # warm-up
    base, t0 = start_path()
    X = st.gels(A, B, opts)
    ms, _, _ = end_path(base, t0, expect_nonzero)
    x = X.to_dense()
    assert bool(torch.isfinite(x).all()) and tuple(x.shape) == (A.n, B.n)
    say(f"  {label}: gels_ms {ms:.3f}")
    return x


def phase_gels():
    """3f: the three routes of gels."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    m, n = QR_M, QR_N
    gen = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn(m, n, generator=gen, device="cuda")
    A = st.Matrix.from_dense(a, nb=NB, grid=grid)
    x0 = torch.randn(n, NRHS, generator=gen, device="cuda")
    with _f32():
        b0 = a @ x0
    qr_opts = {st.Option.MethodGels: st.MethodGels.Geqrf}
    limit = 10 * m * 2.0 ** -24
    say(f"least squares: gels f32 m={m} n={n} nb={NB} nrhs={NRHS}:")
    x = run_gels("Householder route, consistent B", A,
                 st.Matrix.from_dense(b0, nb=NB, grid=grid), qr_opts,
                 {"qr_call": 32})
    err = rel_err(x, x0)
    say(f"    |X - X0|/|X0| {err:.3e} (bound 1e-3)")
    assert err <= 1e-3
    b = torch.randn(m, NRHS, generator=gen, device="cuda")
    B = st.Matrix.from_dense(b, nb=NB, grid=grid)
    x = run_gels("Householder route, Gaussian B", A, B, qr_opts,
                 {"qr_call": 32})
    res = normal_residual(a, x, b)
    say(f"    |A^T(AX-B)|/(|A|(|A||X|+|B|)) {res:.3e} (bound {limit:.3e})")
    assert res <= limit
    assert st.MethodGels.select_algo(A, B) == st.MethodGels.Cholqr
    x = run_gels("default route (CholQR, m >= 2n), Gaussian B", A, B,
                 None, {"potrf_tile": n // NB,
                        "trsm_right_lower_t": n // NB - 1})
    res = normal_residual(a, x, b)
    say(f"    |A^T(AX-B)|/(|A|(|A||X|+|B|)) {res:.3e} (bound {limit:.3e})")
    assert res <= limit
    del A, a
    at = torch.randn(n, m, generator=gen, device="cuda")   # m < n: LQ
    bt = torch.randn(n, NRHS, generator=gen, device="cuda")
    x = run_gels(f"LQ route (m={n}, n={m}), Gaussian B",
                 st.Matrix.from_dense(at, nb=NB, grid=grid),
                 st.Matrix.from_dense(bt, nb=NB, grid=grid), None,
                 {"qr_call": 32, "trsm_left_lower": n // NB})
    with _f32():
        res = float(torch.linalg.norm(at @ x - bt)
                    / (torch.linalg.norm(at) * torch.linalg.norm(x)
                       + torch.linalg.norm(bt)))
    say(f"    |AX-B|/(|A||X|+|B|) {res:.3e} (bound {limit:.3e})")
    assert res <= limit


def phase_gesv_nopiv():
    """3g: the unpivoted LU solve at the LU bench shape."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n = N
    gen = torch.Generator(device="cuda").manual_seed(8)
    a = torch.randn(n, n, generator=gen, device="cuda")
    a.diagonal().add_(float(n))
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    A = st.Matrix.from_dense(a, nb=NB, grid=grid)
    B = st.Matrix.from_dense(b, nb=NB, grid=grid)
    st.gesv_nopiv(A, B)                # warm-up
    base, t0 = start_path()
    X, LU, info = st.gesv_nopiv(A, B)
    ms, launches, peak_gib = end_path(
        base, t0, {"lu_nopiv_tile": n // NB, "trsm_left_lower": n // NB})
    t1 = time.perf_counter()
    st.getrf_nopiv(A)
    torch.cuda.synchronize()
    getrf_ms = (time.perf_counter() - t1) * 1e3
    info = int(info)
    x = X.to_dense()
    lu = LU.to_dense()
    l = torch.tril(lu, -1)
    l.diagonal().fill_(1.0)
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
        f = float(torch.linalg.norm(a - l @ torch.triu(lu))
                  / (n * torch.linalg.norm(a)))
    del l, lu
    limit = 10 * n * 2.0 ** -24
    say(f"unpivoted LU: gesv_nopiv f32 n={n} nb={NB} nrhs={NRHS} Grid(1,1): "
        f"info {info}, residual {r:.3e} (bound {limit:.3e}), |A-LU|/(n|A|) "
        f"{f:.3e} (bound 1e-5)")
    say(f"  getrf_nopiv_ms {getrf_ms:.3f} ({2 * n ** 3 / 3 / getrf_ms / 1e6:.1f}"
        f" GFLOP/s at 2n^3/3), gesv_nopiv_ms {ms:.3f}, gesv_nopiv peak "
        f"device memory above its inputs {peak_gib:.3f} GiB")
    assert info == 0 and bool(torch.isfinite(x).all())
    assert r <= limit and f <= 1e-5, (r, f)
    phase_breakdown("gesv_nopiv", lambda: st.gesv_nopiv(A, B))
    return launches


def phase_qr_nopiv_failure_report():
    """4c: geqrf and gels on the card against the CPU, the fast path and
    its kernel forced (K6 on the card, its plain version on the CPU);
    a zero pivot under gesv_nopiv on both."""
    import slate_tpu_torch as st
    m, n, nb = 1024, 512, 128
    rng = np.random.default_rng(10)
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((m, 3)).astype(np.float32)
    os.environ["SLATE_QR_FAST"] = "1"
    os.environ["SLATE_QR_PANEL"] = "1"
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            grid = st.Grid(1, 1, device=dev)
            A = st.Matrix.from_dense(a, nb=nb, grid=grid)
            QR, T = st.geqrf(A)
            X = st.gels(A, st.Matrix.from_dense(b, nb=nb, grid=grid),
                        {st.Option.MethodGels: st.MethodGels.Geqrf})
            res[dev] = (torch.triu(QR.to_dense()[:n]).cpu(),
                        torch.diagonal(T, dim1=1, dim2=2).cpu(),
                        X.to_dense().cpu())
    finally:
        del os.environ["SLATE_QR_FAST"], os.environ["SLATE_QR_PANEL"]
    errs = [rel_err(res["cuda"][i], res["cpu"][i]) for i in range(3)]
    say(f"small geqrf/gels m={m} n={n} nb={nb} (SLATE_QR_FAST=1, "
        f"SLATE_QR_PANEL=1): card vs CPU rel_err R {errs[0]:.3e}, taus "
        f"{errs[1]:.3e}, X {errs[2]:.3e} (tol {TOL:g})")
    assert max(errs) <= TOL, errs
    nz, nbz = 600, 256
    z = (rng.standard_normal((nz, nz)) + nz * np.eye(nz)).astype(np.float32)
    z[100, :] = 0.0
    z[:, 100] = 0.0
    infos = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        _, _, info = st.gesv_nopiv(
            st.Matrix.from_dense(z, nb=nbz, grid=grid),
            st.Matrix.from_dense(b[:nz], nb=nbz, grid=grid))
        infos[dev] = int(info)
    say(f"unpivoted LU failure report (zero row and column): info card "
        f"{infos['cuda']}, CPU {infos['cpu']}")
    assert infos == {"cuda": 1, "cpu": 1}, infos


# ---------------------------------------------------------------------------
# the two-stage eigensolver and SVD slice
# ---------------------------------------------------------------------------

def chase_work(n, b, which):
    """(flops, bytes) of one chase at (n, b): the flops of every task's
    Householder steps, as this run's shape sets them (a reflector of
    length L = min(b, n − start); the seed tasks have no B block), and
    the bytes of the band read once and d, e and the reflector packs
    written once."""
    S, T = n - 1, (n - 2) // b + 1
    s = np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    start = s + 1 + t * b
    L = np.minimum(b, n - start).astype(np.float64)
    live = start <= n - 1
    chase = t >= 1
    if which == "hb2st":
        # D two-sided 8L²; chase: bulge right-apply 4Lb, left-apply 4L(b−1)
        f = 8 * L * L + 2 * L + chase * (4 * L * b + 4 * L * (b - 1))
        packs = 1
    else:
        # D right-apply 4L², U-side left-apply 4L(L−1); chase: previous U
        # left-apply 4bL, V-side right-apply 4(b−1)L
        f = 4 * L * L + 4 * L * (L - 1) + 4 * L + chase * (
            4 * b * L + 4 * (b - 1) * L + 2 * L)
        packs = 2
    flops = float((f * live).sum())
    nbytes = 4.0 * ((b + 1) * n + 2 * n - 1 + packs * S * T * (b + 1))
    return flops, nbytes


def unit_roundoff(dtype) -> float:
    return 2.0 ** -24 if dtype in (torch.float32, torch.complex64) \
        else 2.0 ** -53


def dense_band(ab, upper):
    """The dense f64 (complex128 for a complex band) matrix of a compact
    band, on the card: upper storage as it is, lower storage as the
    Hermitian band (the upper triangle conjugated, the diagonal real)."""
    b, n = ab.shape[0] - 1, ab.shape[1]
    wide = torch.complex128 if ab.is_complex() else torch.float64
    a = torch.zeros(n, n, dtype=wide, device=ab.device)
    for d in range(b + 1):
        j = torch.arange(n - d, device=ab.device)
        x = ab[d, :n - d].to(wide)
        if not upper and d == 0:
            x = x.real.to(wide)
        a[j, j + d] = x if upper else x.conj()
        if not upper:
            a[j + d, j] = x
    return a


def spectrum(a, upper, gram=True):
    """Eigenvalues (symmetric) or singular values (upper), ascending, of
    a dense f64 matrix. The singular values come from the eigenvalues of
    the Gram matrix aᵀa, in f64: an absolute error of at most
    ~sqrt(n·2⁻⁵²)·‖a‖₂, far inside the f32 bounds they are held to, in
    far less time than ``svdvals`` at n=8192. Without ``gram``, from
    cuSOLVER's QR-iteration SVD (``driver="gesvd"``): the default
    driver's Jacobi SVD reads ~1e4·u of σ_max (3u's witness)."""
    if not upper:
        return torch.linalg.eigvalsh(a)
    if not gram:
        return torch.linalg.svdvals(a, driver="gesvd").flip(0)
    return torch.linalg.eigvalsh(a.mH @ a).clamp_min(0.0).sqrt()


def chase_spectrum(d, e, upper, gram=True):
    d, e = d.double(), e.double()
    t = torch.diag(d) + torch.diag(e, 1)
    return spectrum(t if upper else t + torch.diag(e, -1), upper, gram)


def tridiag_spectrum(d, e, upper):
    """Eigenvalues of the real symmetric tridiagonal (d, e), or singular
    values of the upper bidiagonal (the nonnegative half of its 2n×2n
    Golub–Kahan tridiagonal's eigenvalues), ascending, f64 on the card:
    LAPACK on the host, O(n²), so it serves at n = 8192 in f64."""
    from scipy.linalg import eigvalsh_tridiagonal
    d = d.double().cpu().numpy()
    e = e.double().cpu().numpy()
    if upper:
        n = d.size
        off = np.empty(2 * n - 1)
        off[0::2], off[1::2] = d, e
        w = np.sort(np.abs(eigvalsh_tridiagonal(np.zeros(2 * n), off)[n:]))
    else:
        w = eigvalsh_tridiagonal(d, e)
    return torch.from_numpy(np.ascontiguousarray(w)).to("cuda")


def de_gap(x, y) -> float:
    """Max abs difference of d and |e| between two chase results."""
    return max(float((x[i].double().cpu().abs()
                      - y[i].double().cpu().abs()).abs().max())
               for i in (0, 1))


def check_chase(which, n, b, gen, dtype=torch.float32, with_plain=True):
    """K8 or K9 on one random band of ``dtype`` (complex: O(1) real and
    imaginary parts, a complex a₀₀): the kernel's spectrum against the
    dense f64 (complex128) band's, and its reflectors (and K9's column-0
    phase) rebuilding the band in their packed order (which a task run
    out of order, or two tasks of a wave that collide, would break), both
    within 10·n·u; up to n = CHASE_PLAIN_MAX_N, unless ``with_plain``
    is False, also against its plain version on the card: sweep 0's reflectors, d and |e| (their
    tolerances scaled by u/2⁻²⁴), the plain version's spectrum, and
    phase0 equal. Outside float32, d and e of the real dtype and two runs
    bit for bit equal too (2d checks float32's bits at 8192), and the
    spectra of d and e from LAPACK's tridiagonal solver on the host
    (:func:`tridiag_spectrum`), so that n = 8192 stays cheap. At
    n ≤ 1024 in float32 the plain version also runs in f64 on the card
    and in f32 on the CPU, to show how far f32 rounding alone moves d and
    |e|. Returns the band, the max abs difference of d and |e| and the
    plain version's time (host clock: a host-bound loop of small torch
    ops); None for both above CHASE_PLAIN_MAX_N."""
    from slate_tpu_torch.internal import band_bulge as bb
    from slate_tpu_torch.internal import kernels as K
    from slate_tpu_torch.linalg.bulge import apply_bulge_reflectors
    upper = which == "tb2bd"
    fn = K.tb2bd_chase if upper else K.hb2st_chase
    plain = bb.tb2bd if upper else bb.hb2st
    f32 = dtype == torch.float32
    ab = torch.randn(b + 1, n, generator=gen, device="cuda", dtype=dtype)
    out = fn(ab)
    dense = dense_band(ab, upper)
    # float32's singular values from the Gram matrix, fast at n = 8192
    # and far inside its bound; the wider types' need svdvals
    u = unit_roundoff(dtype)
    # the Gram matrix in f64 (complex128) is far inside the bounds of the
    # single-precision types; the double ones need a true SVD
    want = spectrum(dense, upper, gram=u == 2.0 ** -24)
    norm2 = float(want.abs().max())
    spec_of = ((lambda d, e: chase_spectrum(d, e, upper, True)) if f32
               else (lambda d, e: tridiag_spectrum(d, e, upper)))
    limit, scale = 10 * n * u, u / 2.0 ** -24
    eye = torch.eye(n, device="cuda", dtype=dtype)
    with _f32():
        if upper:
            U2 = apply_bulge_reflectors(out[2], out[3], eye, b)
            V2 = apply_bulge_reflectors(out[4], out[5], eye, b)
            bid = (torch.diag(out[0]) + torch.diag(out[1], 1)).to(dtype)
            rebuilt = U2 @ bid @ V2.mH
            rebuilt[:, 0] *= out[6].conj()
            del U2, V2
        else:
            Q = apply_bulge_reflectors(out[2], out[3], eye, b)
            tri = (torch.diag(out[0]) + torch.diag(out[1], 1)
                   + torch.diag(out[1], -1)).to(dtype)
            rebuilt = Q @ tri @ Q.mH
            del Q, tri
    rec = float(torch.linalg.norm(rebuilt.to(dense.dtype) - dense)
                / torch.linalg.norm(dense))
    del rebuilt, eye
    spec = float((spec_of(out[0], out[1]) - want).abs().max()) / norm2
    ok = (spec <= limit and rec <= limit
          and bool(torch.isfinite(out[0]).all()))
    name = "" if f32 else f" {str(dtype)[6:]}"
    line = (f"  {which}{name} n={n} band={b}: kernel spectrum {spec:.3e}, "
            f"band rebuilt from the kernel's reflectors {rec:.3e} (bound "
            f"{limit:.3e} each)")
    if not f32:
        same = all(torch.equal(x, y) for x, y in zip(out, fn(ab)))
        real = out[0].dtype == out[1].dtype == (
            dtype.to_real() if dtype.is_complex else dtype)
        ok = ok and same and real
        line += f"; two runs bit for bit equal {same}; d, e real {real}"
    mx = plain_ms = note = None
    if with_plain and n <= CHASE_PLAIN_MAX_N:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain(ab)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        mx = de_gap(out, ref)
        sweep0 = max(float((x[0] - y[0]).abs().max())
                     for x, y in zip(out[2:6 if upper else 4],
                                     ref[2:6 if upper else 4]))
        spec_p = float((spec_of(ref[0], ref[1]) - want).abs().max()) / norm2
        phase = not upper or torch.equal(out[6], ref[6])
        ok = (ok and mx <= CHASE_DE_TOL * scale * norm2 and spec_p <= limit
              and sweep0 <= CHASE_SWEEP0_TOL * scale and phase)
        line += (f"; vs plain: d,|e| max_abs_err {mx:.3e} (tol "
                 f"{CHASE_DE_TOL * scale:g}*|A|_2 = "
                 f"{CHASE_DE_TOL * scale * norm2:.3e}), sweep-0 V,tau "
                 f"{sweep0:.3e} (tol {CHASE_SWEEP0_TOL * scale:g}), plain "
                 f"spectrum {spec_p:.3e}, plain_ms {plain_ms:.1f}")
        if upper and not f32:
            line += f", phase0 {complex(out[6]):.6f} equal {phase}"
        if n <= 1024 and f32:
            r64 = plain(ab.double())
            rcpu = plain(ab.cpu())
            note = (f"    f32 rounding: d,|e| distance from the plain version "
                    f"in f64: kernel {de_gap(out, r64):.3e}, plain "
                    f"{de_gap(ref, r64):.3e}; plain on the card vs plain on "
                    f"the CPU (the same code in other summation orders) "
                    f"{de_gap(ref, rcpu):.3e}")
    say(f"{line} {'ok' if ok else 'FAIL'}")
    if note:
        say(note)
    if not ok:
        raise AssertionError(f"{which} {dtype} n={n} band={b} fails its "
                             "checks")
    return ab, mx, plain_ms


def phase_chase_kernels():
    from slate_tpu_torch.internal import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    say("bulge-chase kernel checks (on the card):")
    for which, name in (("hb2st", "hb2st_vmem"), ("tb2bd", "tb2bd_vmem")):
        fn = K.tb2bd_chase if which == "tb2bd" else K.hb2st_chase
        res = {(n, b): check_chase(which, n, b, gen) for n, b in CHASE_SHAPES}
        mx = max(r[1] for r in res.values() if r[1] is not None)
        # the plain version's time at its largest shape, and the kernel's
        # there; the kernel's at the shape of 3h/3j
        n0, b0 = max(k for k, r in res.items() if r[2] is not None)
        ab0, _, plain_ms = res[n0, b0]
        ms0 = time_ms(lambda: fn(ab0), reps=3)
        ab = res[EIG_N, EIG_NB][0]
        del res, ab0
        ms = time_ms(lambda: fn(ab), reps=3)
        S, T = EIG_N - 1, (EIG_N - 2) // EIG_NB + 1
        waves = 2 * (S - 1) + T
        flops, nbytes = chase_work(EIG_N, EIG_NB, which)
        rows[name] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound=bound(flops, nbytes))
        again = fn(ab)
        same = all(torch.equal(x, y) for x, y in zip(fn(ab), again))
        say(f"  {name}: {ms / waves * 1e3:.3f} us per wave-equivalent "
            f"(one launch) against {WAVE_US_BEFORE[which]} in its former "
            f"design of one launch per wave; two runs bit for bit "
            f"equal: {same}")
        assert same, f"{which} chase does not repeat its bits"
        del again
        say(f"  {name}: kernel_ms {ms:.4f} at n={EIG_N} band={EIG_NB} "
            f"({waves} wave-equivalents, {ms / waves * 1e3:.3f} us each); "
            f"at n={n0} band={b0} kernel_ms {ms0:.4f}, plain_ms "
            f"{plain_ms:.4f}; "
            f"library_ms null, bound_ms {rows[name]['bound'][0]:.4f} at "
            f"n={EIG_N} ({rows[name]['bound'][1]}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 2 ** 20:.1f} MiB)")
        del ab
    return rows


def sym_matrix(n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, n, generator=gen, device="cuda")
    return (g + g.T) / 2


def timed_stages(fn):
    """Run ``fn(times)``, a two-stage call given a ``times`` dict: its
    result, the dict and the stage split as text."""
    times = {}
    out = fn(times)
    return out, times, ", ".join(f"{k} {v * 1e3:.3f}"
                                 for k, v in times.items())


def phase_heev_vals():
    """3h: eigenvalues by the two-stage pipeline at the JAX bench shape."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, nb = EIG_N, EIG_NB
    a = sym_matrix(n, 13)
    A = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid)
    opts = {st.Option.MethodEig: st.MethodEig.TwoStage}
    st.heev(st.HermitianMatrix.from_dense(a[:512, :512], nb=nb, grid=grid),
            opts, want_vectors=False)          # warm-up: handles, library
    base, t0 = start_path()
    (lam, Z), _, split = timed_stages(lambda t: st.heev(A, opts, False, t))
    ms, launches, peak_gib = end_path(base, t0, {"hb2st_vmem": 1})
    t1 = time.perf_counter()
    ref = F64_REFS["heev_vals"] = torch.linalg.eigvalsh(a.double())
    ref_s = time.perf_counter() - t1
    norm2 = float(ref.abs().max())
    err = float((lam.double() - ref).abs().max()) / norm2
    limit = 10 * n * 2.0 ** -24
    yard = time_ms(lambda: torch.linalg.eigvalsh(a), reps=1)
    say(f"eig path: heev values f32 n={n} nb={nb} TwoStage Grid(1,1): "
        f"max|lam - lam_ref|/|A|_2 {err:.3e} (bound {limit:.3e}; eigvalsh "
        f"f64 reference took {ref_s:.1f} s)")
    say(f"  heev_vals_ms {ms:.3f} (stage clock on), peak device memory "
        f"above its inputs {peak_gib:.3f} GiB; stage split ms: {split}; "
        f"torch.linalg.eigvalsh f32 (yardstick, not on the path) "
        f"{yard:.3f} ms")
    assert Z is None and tuple(lam.shape) == (n,)
    assert bool(torch.isfinite(lam).all()) and err <= limit, err
    phase_breakdown("heev (values)", lambda: st.heev(A, opts, False),
                    cpu=False)
    return launches


def phase_heev_vectors():
    """3i: eigenpairs by the two-stage pipeline with divide & conquer."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, nb = 4096, 512
    a = sym_matrix(n, 14)
    A = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid)
    opts = {st.Option.MethodEig: st.MethodEig.DC}
    base, t0 = start_path()
    (lam, Z), times, split = timed_stages(lambda t: st.heev(A, opts, times=t))
    ms, launches, peak_gib = end_path(base, t0, {"hb2st_vmem": 1})
    z = Z.to_dense()
    with _f32():
        res = float(torch.linalg.norm(a @ z - z * lam) / torch.linalg.norm(a))
        orth = float(torch.linalg.norm(z.T @ z - torch.eye(n, device="cuda"))
                     / n)
    limit = 10 * n * 2.0 ** -24
    say(f"eig path: heev vectors f32 n={n} nb={nb} (re-blocked to "
        f"{Z.nb}) DC Grid(1,1): |AZ - Z Lambda|/|A| {res:.3e}, "
        f"|Z^T Z - I|/n {orth:.3e} (bound {limit:.3e} each)")
    say(f"  heev_ms {ms:.3f} (stage clock on; stedc host share "
        f"{times['stedc'] * 1e3:.3f} ms of {sum(times.values()) * 1e3:.3f}), "
        f"peak device memory above its inputs {peak_gib:.3f} GiB; stage "
        f"split ms: {split}")
    assert tuple(z.shape) == (n, n) and bool(torch.isfinite(z).all())
    assert res <= limit and orth <= limit, (res, orth)
    return launches


def phase_gesvd_vals():
    """3j: singular values by the two-stage pipeline at the bench shape."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, nb = EIG_N, EIG_NB
    gen = torch.Generator(device="cuda").manual_seed(15)
    a = torch.randn(n, n, generator=gen, device="cuda")
    A = st.Matrix.from_dense(a, nb=nb, grid=grid)
    opts = {st.Option.MethodSVD: st.MethodSVD.TwoStage}
    st.svd_vals(st.Matrix.from_dense(a[:512, :512], nb=nb, grid=grid), opts)
    base, t0 = start_path()
    s, _, split = timed_stages(lambda t: st.gesvd(A, opts, times=t)[0])
    ms, launches, peak_gib = end_path(base, t0, {"tb2bd_vmem": 1})
    t1 = time.perf_counter()
    ref = F64_REFS["gesvd_vals"] = torch.linalg.svdvals(a.double())
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t1
    err = float((s.double() - ref).abs().max()) / float(ref[0])
    limit = 10 * n * 2.0 ** -24
    say(f"svd path: gesvd values f32 {n}x{n} nb={nb} TwoStage Grid(1,1): "
        f"max|s - s_ref|/s_max {err:.3e} (bound {limit:.3e}; svdvals f64 "
        f"reference took {ref_s:.1f} s)")
    say(f"  gesvd_vals_ms {ms:.3f} (stage clock on), peak device memory "
        f"above its inputs {peak_gib:.3f} GiB; stage split ms: {split}")
    assert tuple(s.shape) == (n,) and bool(torch.isfinite(s).all())
    assert err <= limit, err
    phase_breakdown("gesvd (values)", lambda: st.svd_vals(A, opts),
                    cpu=False)
    return launches


def phase_gesvd_vectors():
    """3k: the SVD with U and Vᵀ of a tall matrix."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    m, n, nb = 6144, 4096, EIG_NB
    gen = torch.Generator(device="cuda").manual_seed(16)
    a = torch.randn(m, n, generator=gen, device="cuda")
    A = st.Matrix.from_dense(a, nb=nb, grid=grid)
    base, t0 = start_path()
    (s, U, VT), _, split = timed_stages(
        lambda t: st.gesvd(A, {st.Option.MethodSVD: st.MethodSVD.TwoStage},
                           True, True, t))
    ms, launches, peak_gib = end_path(base, t0, {"tb2bd_vmem": 1})
    u, vt = U.to_dense(), VT.to_dense()
    eye = torch.eye(n, device="cuda")
    with _f32():
        rec = float(torch.linalg.norm(a - (u * s) @ vt) / torch.linalg.norm(a))
        ou = float(torch.linalg.norm(u.T @ u - eye) / n)
        ov = float(torch.linalg.norm(vt @ vt.T - eye) / n)
    limit = 10 * m * 2.0 ** -24
    say(f"svd path: gesvd U, VT f32 {m}x{n} nb={nb} TwoStage Grid(1,1): "
        f"|A - U S VT|/|A| {rec:.3e}, |U^T U - I|/n {ou:.3e}, "
        f"|V^T V - I|/n {ov:.3e} (bound {limit:.3e} each)")
    say(f"  gesvd_ms {ms:.3f} (stage clock on), peak device memory above "
        f"its inputs {peak_gib:.3f} GiB; stage split ms: {split}")
    assert tuple(u.shape) == (m, n) and tuple(vt.shape) == (n, n)
    assert max(rec, ou, ov) <= limit, (rec, ou, ov)
    return launches


def phase_eig_failure_report():
    """4d: NaN, zero matrix, card against CPU."""
    import slate_tpu_torch as st
    n, nb = 256, 32
    eo = {st.Option.MethodEig: st.MethodEig.TwoStage}
    so = {st.Option.MethodSVD: st.MethodSVD.TwoStage}
    rng = np.random.default_rng(17)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = (g + g.T) / 2
    grid = st.Grid(1, 1)
    bad = a.copy()
    bad[40, 7] = bad[7, 40] = np.nan
    raised = []
    for fn, M, o in ((st.eig_vals, st.HermitianMatrix, eo),
                     (st.svd_vals, st.Matrix, so)):
        try:
            fn(M.from_dense(bad, nb=nb, grid=grid), o)
        except st.SlateError as e:
            raised.append(str(e))
    say(f"eig/svd failure report: NaN input raises SlateError on the card: "
        f"{len(raised)} of 2 ({'; '.join(raised)})")
    assert len(raised) == 2
    z = np.zeros((n, n), np.float32)
    lz = st.eig_vals(st.HermitianMatrix.from_dense(z, nb=nb, grid=grid), eo)
    sz = st.svd_vals(st.Matrix.from_dense(z, nb=nb, grid=grid), so)
    say(f"  zero matrix: max|lambda| {float(lz.abs().max()):.3e}, "
        f"max sigma {float(sz.abs().max()):.3e}")
    assert float(lz.abs().max()) == 0.0 and float(sz.abs().max()) == 0.0
    vals = {}
    for dev in ("cuda", "cpu"):
        gr = st.Grid(1, 1, device=dev)
        vals[dev] = (st.eig_vals(st.HermitianMatrix.from_dense(a, nb=nb,
                                                               grid=gr), eo),
                     st.svd_vals(st.Matrix.from_dense(g, nb=nb, grid=gr), so))
    limit = 10 * n * 2.0 ** -24
    el = float((vals["cuda"][0].cpu() - vals["cpu"][0]).abs().max()
               / vals["cpu"][0].abs().max())
    es = float((vals["cuda"][1].cpu() - vals["cpu"][1]).abs().max()
               / vals["cpu"][1].max())
    say(f"  small heev/gesvd n={n} nb={nb}: card vs CPU max|d lambda|/|A| "
        f"{el:.3e}, max|d sigma|/s_max {es:.3e} (bound {limit:.3e})")
    assert el <= limit and es <= limit, (el, es)


# ---------------------------------------------------------------------------
# the Aasen and band LU slice
# ---------------------------------------------------------------------------

def swap_bound(h, w):
    """K10's least time: per column j the multipliers below it and the
    rank-1 update right of it (a product and a difference each), and
    the panel read and written once."""
    flops = sum((h - j - 1) * (1 + 2 * (w - j - 1)) for j in range(min(h, w)))
    return bound(flops, 2 * h * w * 4 + (min(h, w) + 1) * 4)


def rank_k_bound(m, n, k):
    return bound(2 * m * n * k, (m * k + k * n + 2 * m * n) * 4)


def tie_panel(h=128, w=128, seed=0):
    """Column 1 ties, after step 0 swaps rows 0 and 3, between position 1
    and position 3 (where row 0 went): B6's current-position rule takes
    1, a tie broken on the original row index would take 3."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((h, w)).astype(np.float32)
    a[:, 0] = 0.0
    a[0, 0], a[3, 0] = 1.0, 4.0
    a[:, 1] = rng.integers(-1, 2, h)
    a[0, 1], a[1, 1], a[3, 1] = 3.0, 2.0, 4.0
    return torch.from_numpy(a).cuda()


def check_swap(label, a, bitwise=False):
    """K10 against its plain version: pivots, info and the NaN pattern
    equal, values within LU_ATOL, and with ``bitwise`` every bit equal;
    returns (max_abs_err, piv)."""
    from slate_tpu_torch.internal import kernels as K
    lu, piv, info = K.panel_plu_swap(a)
    lu_p, piv_p, info_p = K.panel_plu_swap_plain(a)
    torch.cuda.synchronize()
    fin = ~torch.isnan(lu_p)
    mx = float((lu[fin] - lu_p[fin]).abs().max())
    same = (torch.equal(piv, piv_p) and int(info) == int(info_p)
            and torch.equal(torch.isnan(lu), ~fin))
    bits = torch.equal(lu.view(torch.int32), lu_p.view(torch.int32))
    ok = same and mx <= LU_ATOL and (bits or not bitwise)
    say(f"  panel_plu_swap {label}: pivots/info/NaN pattern equal {same} "
        f"(info {int(info)}), max_abs_err {mx:.3e} (tol {LU_ATOL:g}), "
        f"bits equal {bits}{' (required)' if bitwise else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"panel_plu_swap {label} disagrees with its "
                             "plain version")
    return mx, piv


def phase_swap_rank_k_kernels():
    """2e: K10 and K11 against their plain versions, timed at the path
    shapes."""
    from slate_tpu_torch.internal import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {}
    say("Aasen and band LU kernel checks (kernel vs plain on the card):")
    h, w = N - AASEN_NB, AASEN_NB
    a = torch.randn(h, w, generator=gen, device="cuda")
    mx, _ = check_swap(f"[{h},{w}]", a, bitwise=True)
    for hh, ww in ((2048, AASEN_NB), (300, 128)):
        m2, _ = check_swap(f"[{hh},{ww}]", torch.randn(
            hh, ww, generator=gen, device="cuda"), bitwise=True)
        mx = max(mx, m2)
    m2, piv = check_swap("tie [128,128]", tie_panel())
    mx = max(mx, m2)
    assert piv[:2].tolist() == [3, 1], piv[:2]
    nan = torch.randn(256, 128, generator=gen, device="cuda")
    nan[40, 7] = float("nan")
    _, piv = check_swap("NaN [256,128]", nan)
    assert int(piv[7]) == 256
    zero = torch.randn(256, 128, generator=gen, device="cuda")
    zero[:, 0] = 0.0
    check_swap("zero column [256,128]", zero)
    rows["panel_plu_pallas"] = dict(max_abs_err=mx, **swap_row(a))
    r = rows["panel_plu_pallas"]
    say(f"  panel_plu_swap [{h},{w}]: {r['ms'] / w * 1e3:.2f} us per column")
    mx = 0.0
    empty_ms = time_ms(empty_launcher())
    for (m, n, k) in ((32, 96, 96), (4096, 4096, 64), (70, 130, 1)):
        c = torch.randn(m, n, generator=gen, device="cuda")
        x = torch.randn(m, k, generator=gen, device="cuda")
        y = torch.randn(k, n, generator=gen, device="cuda")
        m2 = check("rank_k_tail", lambda: K.rank_k_tail(c, x, y, -1.0, 1.0),
                   lambda: K.rank_k_tail_plain(c, x, y, -1.0, 1.0),
                   f"[{m},{k}]x[{k},{n}]")
        mx = max(mx, m2)
        if k == 1:
            continue
        with _f32():
            lib = time_ms(lambda: torch.addmm(c, x, y, alpha=-1.0))
        ms = time_ms(lambda: K.rank_k_tail(c, x, y, -1.0, 1.0))
        say(f"  rank_k_tail [{m},{k}]x[{k},{n}]: kernel_ms {ms:.6f}, "
            f"addmm_ms {lib:.6f}, empty kernel {empty_ms:.6f} ms; above "
            f"that floor {(ms - empty_ms) * 1e3:.2f} us against "
            f"{(lib - empty_ms) * 1e3:.2f}; bound_ms "
            f"{rank_k_bound(m, n, k)[0]:.6f} ({rank_k_bound(m, n, k)[1]})")
        if (m, n, k) == (32, 96, 96):
            rows["rank_k_tail_pallas"] = dict(
                ms=ms, plain_ms=time_ms(lambda: K.rank_k_tail_plain(
                    c, x, y, -1.0, 1.0)),
                library_ms=lib, bound=rank_k_bound(m, n, k))
    rows["rank_k_tail_pallas"]["max_abs_err"] = mx
    rank_k_tiers(gen)
    for name, r in rows.items():
        say(f"  {name}: kernel_ms {r['ms']:.4f}, plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f}, "
            f"bound_ms {r['bound'][0]:.6f} ({r['bound'][1]})")
    return rows


def rank_k_tiers(gen):
    """K11 at each precision tier at the three shapes of 2e: against its
    plain version (α = −1, β = 1) and, as a pure product (α = 1, β = 0),
    against the f64 product within (TIER_EPS + k·2⁻²⁴)·|A|·|B|
    elementwise (mxu_bf16: 2·2⁻⁸ + 2⁻¹⁶ for its two rounded operands,
    ``precision.product_bound``); at the two timed shapes its time
    beside ``tier_addmm`` at the same tier."""
    from slate_tpu_torch.internal import kernels as K
    from slate_tpu_torch.internal import precision as P
    for (m, n, k) in ((32, 96, 96), (4096, 4096, 64), (70, 130, 1)):
        c = torch.randn(m, n, generator=gen, device="cuda")
        x = torch.randn(m, k, generator=gen, device="cuda")
        y = torch.randn(k, n, generator=gen, device="cuda")
        ref = x.double() @ y.double()
        den = x.double().abs() @ y.double().abs()
        for tier in P.TIERS:
            check("rank_k_tail", lambda: K.rank_k_tail(c, x, y, -1.0, 1.0,
                                                       tier),
                  lambda: K.rank_k_tail_plain(c, x, y, -1.0, 1.0, tier),
                  f"{tier} [{m},{k}]x[{k},{n}]")
            prod = K.rank_k_tail(c, x, y, 1.0, 0.0, tier)
            err = float(((prod.double() - ref).abs() / den).max())
            lim = P.product_bound(tier, k)
            say(f"  rank_k_tail {tier} [{m},{k}]x[{k},{n}] vs f64: max "
                f"error / (|A||B|) {err:.3e} (bound {lim:.3e}) "
                f"{'ok' if err <= lim else 'FAIL'}")
            assert err <= lim, f"rank_k_tail {tier}: error {err} above {lim}"
            if k == 1:
                continue
            ms = time_ms(lambda: K.rank_k_tail(c, x, y, -1.0, 1.0, tier))
            lib = time_ms(lambda: P.tier_addmm(c, x, y, alpha=-1.0,
                                               tier=tier))
            say(f"  rank_k_tail {tier} [{m},{k}]x[{k},{n}]: kernel_ms "
                f"{ms:.6f}, tier_addmm_ms {lib:.6f}")


def phase_tier_products():
    """2f: the three tiers' trailing product at [15360, 1024]·[1024,
    15360] (the first posv step's syrk shape as one gemm): time of
    ``tier_addmm_`` into C beside the FP32 ``addmm``, and the max error
    relative to |A|·|B| against the f64 product; at k = 1 each tier
    within its per-product bound (TIER_EPS for bf16_6x and bf16_3x,
    2·2⁻⁸ + 2⁻¹⁶ for mxu_bf16's two rounded operands)."""
    from slate_tpu_torch.internal import precision as P
    gen = torch.Generator(device="cuda").manual_seed(31)
    m, k = N - NB, NB
    a = torch.randn(m, k, generator=gen, device="cuda")
    b = torch.randn(k, m, generator=gen, device="cuda")
    c = torch.randn(m, m, generator=gen, device="cuda")
    with _f32():
        fp32_ms = time_ms(lambda: c.addmm_(a, b, alpha=-1.0), reps=5)
    say(f"tier products [{m},{k}]x[{k},{m}]: FP32 addmm_ms {fp32_ms:.3f} "
        f"({2 * m * m * k / fp32_ms / 1e9:.1f} TFLOP/s)")
    ref = a.double() @ b.double()
    den = a.double().abs() @ b.double().abs()
    for tier in P.TIERS:
        ms = time_ms(lambda: P.tier_addmm_(c, a, b, alpha=-1.0, tier=tier),
                     reps=5)
        err = float(((P.tier_mm(a, b, tier).double() - ref).abs()
                     / den).max())
        lim = P.product_bound(tier, k)
        say(f"  {tier}: tier_addmm_ms {ms:.3f} ({2 * m * m * k / ms / 1e9:.1f}"
            f" TFLOP/s, {fp32_ms / ms:.2f}x FP32), max error / (|A||B|) "
            f"{err:.3e} at k={k} (bound {lim:.3e})")
        assert err <= lim, f"{tier}: error {err} above {lim} at k={k}"
    del ref, den
    a1, b1 = a[:, :1].contiguous(), b[:1].contiguous()
    ref = a1.double() @ b1.double()
    den = a1.double().abs() @ b1.double().abs()
    for tier in P.TIERS:
        err = float(((P.tier_mm(a1, b1, tier).double() - ref).abs()
                     / den).max())
        lim = P.product_bound(tier, 0)
        say(f"  {tier} at k=1: max error / (|a||b|) {err:.3e} (TIER_EPS "
            f"{P.TIER_EPS[tier]:.3e}, per-product bound {lim:.3e})")
        assert err <= lim, f"{tier}: error {err} above {lim} at k=1"


def ldl_yardstick(a, b):
    """``torch.linalg.ldl_factor_ex`` + ``ldl_solve`` in f32 where this
    PyTorch build has them on CUDA, else ``torch.linalg.solve``: the
    name and its time (one run after a warm-up)."""
    def ldl():
        ld, pv, _ = torch.linalg.ldl_factor_ex(a)
        return torch.linalg.ldl_solve(ld, pv, b)
    try:
        ldl()
        return "ldl_factor_ex+ldl_solve", time_ms(ldl, reps=1)
    except RuntimeError as e:
        say(f"  ldl_factor_ex on CUDA not available: {e}")
        return "linalg.solve", time_ms(lambda: torch.linalg.solve(a, b),
                                       reps=1)


def phase_hesv():
    """3l: the Aasen solve at the package's headline size."""
    import slate_tpu_torch as st
    from slate_tpu_torch import runtime
    from slate_tpu_torch.linalg import hetrf as H
    grid = st.Grid(1, 1)
    n, nb = N, AASEN_NB
    a = sym_matrix(n, 19)
    gen = torch.Generator(device="cuda").manual_seed(20)
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    A = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    st.hesv(st.HermitianMatrix.from_dense(a[:1024, :1024], nb=nb, grid=grid),
            st.Matrix.from_dense(b[:1024], nb=nb, grid=grid))   # warm-up
    base, t0 = start_path()
    times = {}
    X, (L, FT, piv), info = st.hesv(A, B, times=times)
    nt = n // nb
    ms, launches, peak_gib = end_path(
        base, t0, {"panel_plu_pallas": nt - 1, "trsm_left_lower": nt})
    t1 = time.perf_counter()
    st.hetrf(A)
    torch.cuda.synchronize()
    hetrf_ms = (time.perf_counter() - t1) * 1e3
    info = int(info)
    x = X.to_dense()
    limit = 10 * n * 2.0 ** -24
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
    # P·A·Pᵀ − L·T·Lᵀ from the loop's own T blocks (stage 1 run again)
    w = H._mirror_full(A)
    Td, Ts, piv2, _ = H._hetrf_aasen(w, n, nb)
    ld = H._build_L(w, nb)[:n, :n]
    del w
    t = torch.block_diag(*Td)
    for k in range(nt - 1):
        t[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = Ts[k]
        t[k * nb:(k + 1) * nb, (k + 1) * nb:(k + 2) * nb] = Ts[k].T
    perm = torch.from_numpy(runtime.resolve_pivots(piv.cpu().numpy(), n)
                            ).cuda()
    with _f32():
        f = float(torch.linalg.norm(a[perm][:, perm] - ld @ t @ ld.T)
                  / torch.linalg.norm(a))
    del t, ld
    same = torch.equal(piv, piv2)
    name, yard = ldl_yardstick(a, b)
    split = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
    say(f"Aasen path: hesv f32 n={n} nb={nb} nrhs={NRHS} Grid(1,1): info "
        f"{info}, residual {r:.3e}, |PAP^T - LTL^T|/|A| {f:.3e} (bound "
        f"{limit:.3e} each), pivots repeat {same}")
    say(f"  hetrf_ms {hetrf_ms:.3f}, hesv_ms {ms:.3f} (stage clock on; "
        f"split ms: {split}), hesv peak device memory above its inputs "
        f"{peak_gib:.3f} GiB; torch.linalg.{name} f32 (yardstick, not on "
        f"the path) {yard:.3f} ms")
    assert info == 0, f"hesv info {info}"
    assert tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all())
    assert r <= limit and f <= limit and same, (r, f, same)
    phase_breakdown("hesv", lambda: st.hesv(A, B), host_top=6)
    return launches


def band_matrix(n, kl, ku, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(n, n, generator=gen, device="cuda")
    i = torch.arange(n, device="cuda")
    d = i[None, :] - i[:, None]
    return a.masked_fill_((d > ku) | (-d > kl), 0.0)


def phase_gbsv():
    """3m: the band LU solve at the package's headline size."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, kl, ku, nb = N, BAND_KL, BAND_KU, AASEN_NB
    a = band_matrix(n, kl, ku, 21)
    b = torch.randn(n, NRHS, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(22))
    A = st.BandMatrix.from_dense(a, nb=nb, grid=grid, kl=kl, ku=ku)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    st.gbsv(st.BandMatrix.from_dense(a[:1024, :1024], nb=nb, grid=grid,
                                     kl=kl, ku=ku),
            st.Matrix.from_dense(b[:1024], nb=nb, grid=grid))   # warm-up
    base, t0 = start_path()
    X, F, piv, info = st.gbsv(A, B)
    panels = -(-n // F.nb)
    ms, launches, peak_gib = end_path(base, t0,
                                      {"rank_k_tail_pallas": panels})
    t1 = time.perf_counter()
    st.gbtrf(A)
    torch.cuda.synchronize()
    gbtrf_ms = (time.perf_counter() - t1) * 1e3
    info = int(info)
    x = X.to_dense()
    limit = 10 * n * 2.0 ** -24
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
    moved = int((piv.reshape(-1)[:n].cpu() != torch.arange(n)).sum())
    say(f"band path: gbsv f32 n={n} kl={kl} ku={ku} (band block {F.nb}, "
        f"{panels} panels) nrhs={NRHS} Grid(1,1): info {info}, residual "
        f"{r:.3e} (bound {limit:.3e}), {moved} rows pivoted")
    say(f"  gbtrf_ms {gbtrf_ms:.3f}, gbsv_ms {ms:.3f}, gbsv peak device "
        f"memory above its inputs {peak_gib:.3f} GiB")
    assert info == 0 and F.nb == 96 and moved > 0, (info, F.nb, moved)
    assert tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all())
    assert r <= limit, f"residual {r} above {limit}"
    phase_breakdown("gbsv", lambda: st.gbsv(A, B), host_top=6)
    return launches


def phase_aasen_band_failure_report():
    """4e: a singular symmetric matrix gives the same hetrf info on the
    card and on the CPU; hesv and gbsv agree between the two: equal
    pivots and info, X within the forward error bound n·2⁻²⁴·κ(A)."""
    import slate_tpu_torch as st
    n, nb = 512, 128
    rng = np.random.default_rng(23)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = (g + g.T) / 2
    b = rng.standard_normal((n, 3)).astype(np.float32)
    z = a.copy()
    z[100, :] = z[:, 100] = 0.0
    infos, out = {}, {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        infos[dev] = int(st.hetrf(st.HermitianMatrix.from_dense(
            z, nb=nb, grid=grid))[1])
        X, (_, _, piv), info = st.hesv(
            st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
            st.Matrix.from_dense(b, nb=nb, grid=grid))
        ab = band_matrix(n, BAND_KL, BAND_KU, 24).cpu().numpy()
        Y, _, bpiv, binfo = st.gbsv(
            st.BandMatrix.from_dense(ab, nb=nb, grid=grid, kl=BAND_KL,
                                     ku=BAND_KU),
            st.Matrix.from_dense(b, nb=nb, grid=grid))
        out[dev] = (X.to_dense().cpu(), piv.cpu(), int(info),
                    Y.to_dense().cpu(), bpiv.cpu(), int(binfo))
    ex, ey = rel_err(out["cuda"][0], out["cpu"][0]), rel_err(out["cuda"][3],
                                                             out["cpu"][3])
    same = (torch.equal(out["cuda"][1], out["cpu"][1])
            and torch.equal(out["cuda"][4], out["cpu"][4]))
    # two backward-stable f32 solves may differ by the forward error
    # bound n·2⁻²⁴·κ(A) each; a random symmetric A has a small eigenvalue
    tx = n * 2.0 ** -24 * float(np.linalg.cond(a.astype(np.float64)))
    ty = n * 2.0 ** -24 * float(np.linalg.cond(ab.astype(np.float64)))
    say(f"Aasen/band failure report: singular hetrf info card "
        f"{infos['cuda']}, CPU {infos['cpu']}; n={n}: pivots equal {same}, "
        f"hesv X rel_err {ex:.3e} (bound n*2^-24*cond(A) = {tx:.3e}), gbsv "
        f"X rel_err {ey:.3e} (bound {ty:.3e})")
    assert infos["cuda"] == infos["cpu"] > 0, infos
    assert same and out["cuda"][2] == out["cpu"][2] == 0
    assert out["cuda"][5] == out["cpu"][5] == 0
    assert ex <= tx and ey <= ty, (ex, ey)


# ---------------------------------------------------------------------------
# the mixed-precision slice
# ---------------------------------------------------------------------------

MIXED_NRHS = NB           # gesv_mixed_3x_16k's nrhs (bench.py:886-922)
IR_ITERMAX = 30           # Option.MaxIterations' default


def mixed_matrices():
    """The matrices of 3n–3p at n = 16384, nb = 1024, f32 on the card:
    A = 0.01·G + √n·I, the JAX bench's ``gesv_mixed_3x_16k`` matrix built
    the same way (``scale``, ``_add_scaled_identity``), and the posv
    matrix S = G·Gᵀ/n + I of phase 3 (``gemm``)."""
    import slate_tpu_torch as st
    from slate_tpu_torch.ops.elementwise import _add_scaled_identity
    grid = st.Grid(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(40)
    G = st.Matrix.from_dense(torch.randn(N, N, generator=gen, device="cuda"),
                             nb=NB, grid=grid)
    A = _add_scaled_identity(st.scale(0.01, 1.0, G), N ** 0.5)
    I = st.set_matrix(0.0, 1.0, st.Matrix.zeros(N, N, NB, grid))
    C = st.gemm(1.0 / N, G, st.transpose(G), 1.0, I)
    del G, I
    S = st.HermitianMatrix(data=C.data, m=N, n=N, nb=NB, grid=grid)
    return A, S


def backward_error(M, X, B) -> float:
    """‖M·X − B‖_F / (‖M‖_F·‖X‖_F) in f64 on the card."""
    m, x, b = (T.to_dense().double() for T in (M, X, B))
    return float(torch.linalg.norm(m @ x - b)
                 / (torch.linalg.norm(m) * torch.linalg.norm(x)))


def run_mixed(label, solver, M, B, full_solver, chol, warm=False):
    """One mixed solve with the launch counts set to 0 just before it and
    read just after: ``iters``, time, backward error, no fallback, and
    the exact counts (K1 16 and K2 15, or K4 128 and K5 16 + 16, per
    factorization, K3 16 per ``potrs``/``getrs`` call, counted by wrapping
    the two functions); then the full-precision solve at the same shape
    (one run)."""
    from slate_tpu_torch.linalg import getrf as getrf_mod
    from slate_tpu_torch.linalg import mixed
    from slate_tpu_torch.linalg import potrf as potrf_mod
    if warm:
        solver(M, B)
    calls = [0]
    real = getrf_mod.getrs, potrf_mod.potrs

    def counted(fn):
        def run(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return run

    getrf_mod.getrs, potrf_mod.potrs = (counted(f) for f in real)
    try:
        base, t0 = start_path()
        X, iters, info = solver(M, B)
        torch.cuda.synchronize()
        nt = N // NB
        expect = ({"potrf_tile": nt, "trsm_right_lower_t": nt - 1} if chol
                  else {"plu_call_folded_block": nt * NB // 128,
                        "fold_panel": nt, "unfold_panel": nt})
        expect["trsm_left_lower"] = nt * calls[0]
        ms, launches, peak_gib = end_path(base, t0, expect)
    finally:
        getrf_mod.getrs, potrf_mod.potrs = real
    fell_back = mixed.used_fallback()
    info = int(info)
    eps = torch.finfo(B.dtype).eps
    err = backward_error(M, X, B)
    limit = 10 * N * eps / 2
    t1 = time.perf_counter()
    full_solver(M, B)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t1) * 1e3
    say(f"  {label} {str(B.dtype)[6:]} nrhs={B.n}: iters {iters}, info {info}"
        f", fallback {fell_back}, {calls[0]} solves, ms {ms:.3f}, backward "
        f"error {err:.3e} (bound 10*n*eps/2 = {limit:.3e}); full-precision "
        f"solve ms {full_ms:.3f}, peak device memory above its inputs "
        f"{peak_gib:.3f} GiB")
    assert info == 0 and not fell_back and iters < IR_ITERMAX, (
        info, fell_back, iters)
    assert tuple(X.shape) == tuple(B.shape) and X.dtype == B.dtype
    assert bool(torch.isfinite(X.data).all()) and err <= limit, err
    return launches


def factor_tiers(A, S):
    """The low leg's factorizations alone: getrf (fast path) and potrf
    at n = 16384 at bf16_3x and bf16_6x, alternating, best of two."""
    import slate_tpu_torch as st
    best = {}
    for tier in ("bf16_6x", "bf16_3x") * 2:
        opts = {st.Option.TrailingPrecision: tier}
        for name, fn in (("getrf", lambda: st.getrf(A, opts)),
                         ("potrf", lambda: st.potrf(S, opts))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = fn()[-1]
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) * 1e3
            assert int(info) == 0
            best[name, tier] = min(best.get((name, tier), t), t)
    for name, flops in (("getrf", 2 * N ** 3 / 3), ("potrf", N ** 3 / 3)):
        say(f"  {name} n={N} by tier: " + ", ".join(
            f"{t} {best[name, t]:.3f} ms ({flops / best[name, t] / 1e6:.1f}"
            f" GFLOP/s)" for t in ("bf16_6x", "bf16_3x")))


def phase_mixed():
    """3n: gesv_mixed and posv_mixed at f32 (bf16_3x factorizations) and
    f64 (f32 factorizations), and both GMRES-IR forms at f64, at
    n = 16384, nb = 1024, through the package's entry points."""
    import slate_tpu_torch as st
    A, S = mixed_matrices()
    grid = A.grid
    gen = torch.Generator(device="cuda").manual_seed(41)

    def rhs(k, dt):
        return st.Matrix.from_dense(torch.randn(N, k, generator=gen,
                                                device="cuda").to(dt),
                                    nb=NB, grid=grid)

    say(f"mixed solves n={N} nb={NB} Grid(1,1): A = 0.01*G + sqrt(n)*I, "
        f"S = G*G^T/n + I")
    counts = {}
    B = rhs(MIXED_NRHS, torch.float32)
    counts["gesv_mixed"] = run_mixed(
        "gesv_mixed", st.gesv_mixed, A, B, lambda M, R: st.gesv(M, R),
        chol=False, warm=True)
    B8 = rhs(NRHS, torch.float32)
    counts["posv_mixed"] = run_mixed(
        "posv_mixed", st.posv_mixed, S, B8, lambda M, R: st.posv(M, R),
        chol=True, warm=True)
    factor_tiers(A, S)
    A64, S64 = A.astype(torch.float64), S.astype(torch.float64)
    del A, S
    B8 = B8.astype(torch.float64)
    B1 = rhs(1, torch.float64)
    run_mixed("gesv_mixed", st.gesv_mixed, A64, B8,
              lambda M, R: st.gesv(M, R), chol=False)
    run_mixed("posv_mixed", st.posv_mixed, S64, B8,
              lambda M, R: st.posv(M, R), chol=True)
    run_mixed("gesv_mixed_gmres", st.gesv_mixed_gmres, A64, B1,
              lambda M, R: st.gesv(M, R), chol=False)
    run_mixed("posv_mixed_gmres", st.posv_mixed_gmres, S64, B1,
              lambda M, R: st.posv(M, R), chol=True)
    X, _, _ = st.gesv_mixed(A64, B8)
    gemm_ms = time_ms(lambda: st.gemm(-1.0, A64, X, 1.0, B8), reps=3)
    say(f"  one f64 residual B - A*X (nrhs={NRHS}): gemm_ms {gemm_ms:.3f}, "
        f"the tiles-to-dense copy of A alone moves "
        f"{2 * N * N * 8 / 2 ** 30:.1f} GiB "
        f"({2 * N * N * 8 / HBM_RATE * 1e3:.3f} ms at the byte rate)")
    phase_breakdown("f64 gesv_mixed", lambda: st.gesv_mixed(A64, B8))
    return counts


def phase_norms_health():
    """3o: ``norm`` of each kind on a general, a Lower Hermitian (junk
    above the diagonal) and a triangular matrix against torch in f64;
    ``potrf``/``getrf(health=True)`` growth against the true rcond from
    ``torch.linalg.inv`` in f64; ``hetrf(health=True)`` at n = 4096,
    nb = 256 with its exact launch counts."""
    import slate_tpu_torch as st
    A, S = mixed_matrices()
    grid = A.grid
    a = A.to_dense().double()
    s = S.to_dense()
    gen = torch.Generator(device="cuda").manual_seed(42)
    junk = torch.randn(N, N, device="cuda", generator=gen)
    H = st.HermitianMatrix.from_dense(torch.tril(s) + torch.triu(junk, 1),
                                      nb=NB, grid=grid)
    del junk
    s = s.double()
    h = torch.tril(s) + torch.tril(s, -1).mT
    T = st.TriangularMatrix(data=A.data, m=N, n=N, nb=NB, grid=grid,
                            uplo=st.Uplo.Lower)
    refs = {"Max": lambda x: x.abs().max(),
            "One": lambda x: x.abs().sum(0).max(),
            "Inf": lambda x: x.abs().sum(1).max(),
            "Fro": lambda x: torch.linalg.norm(x)}
    limit = N * 2.0 ** -24
    for label, M, dense in (("general", A, a), ("Lower Hermitian", H, h),
                            ("lower triangular", T, torch.tril(a))):
        errs = {}
        for kind, ref in refs.items():
            t0 = time.perf_counter()
            out = st.norm(getattr(st.Norm, kind), M)
            out = float(out)
            ms = (time.perf_counter() - t0) * 1e3
            r = float(ref(dense))
            errs[kind] = (abs(out - r) / r, ms)
        say(f"  norm {label} n={N}: " + ", ".join(
            f"{k} rel_err {e:.2e} ({ms:.2f} ms)" for k, (e, ms)
            in errs.items()) + f" (bound n*2^-24 = {limit:.2e})")
        assert all(e <= limit for e, _ in errs.values()), errs
    del H, h, T
    for label, fn, M, dense in (
            ("potrf", lambda: st.potrf(S, health=True), S, s),
            ("getrf", lambda: st.getrf(A, health=True), A, a)):
        t0 = time.perf_counter()
        rep = fn()[-1]
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        (st.potrf(S) if label == "potrf" else st.getrf(A))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rcond = RCOND[label] = true_rcond(dense)
        say(f"  {label}(health=True): info {rep.info}, growth (rcond "
            f"estimate) {rep.growth:.6e}, true rcond {rcond:.6e} "
            f"(ratio {rep.growth / rcond:.4f}, bounds [1 - 1e-4, 10]); "
            f"{ms:.1f} ms against {plain_ms:.1f} ms without health")
        assert rep.info == 0 and rep.first_bad_tile is None
        assert rcond * (1 - 1e-4) <= rep.growth <= 10 * rcond
    del A, S, a, s
    n, nb = 4096, AASEN_NB
    g = torch.randn(n, n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(43))
    Hs = st.HermitianMatrix.from_dense(torch.tril((g + g.T) / 2), nb=nb,
                                       grid=grid)
    base, t0 = start_path()
    _, rep = st.hetrf(Hs, health=True)
    ms, launches, _ = end_path(base, t0, {"panel_plu_pallas": n // nb - 1})
    say(f"  hetrf(health=True) n={n} nb={nb}: info {rep.info}, ms {ms:.1f}")
    assert isinstance(rep, st.HealthReport) and rep.info == 0 and rep.ok
    return launches


RCOND = {}          # 3o's true rcond of its potrf and getrf matrices, for 3x


def true_rcond(dense) -> float:
    """1/(‖A‖₁·‖A⁻¹‖₁) of a float64 matrix on the card."""
    inv = torch.linalg.inv(dense)
    return 1.0 / float(dense.abs().sum(0).max() * inv.abs().sum(0).max())


def inverse_ratio(a, x) -> float:
    """LAPACK's test ratio ‖I − A·X‖₁ / (n·‖A‖₁·‖X‖₁·ε), ε = 2⁻²⁴, with
    the product in full FP32."""
    n = a.shape[0]
    with _f32():
        r = a @ x
    r.diagonal().sub_(1.0)
    one = (lambda t: float(t.abs().sum(0).max()))
    return one(r) / (n * one(a) * one(x) * 2.0 ** -24)


def phase_inverses():
    """3p: getri and potri at n = 16384, f32, with LAPACK's test ratio,
    and K3 on trtri's wide identity right-hand side ([1024, 16384])
    beside ``solve_triangular``."""
    import slate_tpu_torch as st
    from slate_tpu_torch.internal import kernels as K
    A, S = mixed_matrices()
    for label in ("getri", "potri"):
        if label == "getri":
            LU, piv, info = st.getrf(A)
            fn, M = (lambda: st.getri(LU, piv)), A
        else:
            L, info = st.potrf(S)
            fn, M = (lambda: st.potri(L)), S
        assert int(info) == 0
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ratio = inverse_ratio(M.to_dense(), X.to_dense())
        say(f"  {label} n={N} nb={NB}: ms {ms:.3f}, ratio |I - A*X|_1/(n*|A|_1"
            f"*|X|_1*eps) {ratio:.3e} (bound 30)")
        assert ratio <= 30, f"{label} ratio {ratio}"
        del X
    gen = torch.Generator(device="cuda").manual_seed(44)
    l = lower_factor(NB, gen)
    b = torch.zeros(NB, N, device="cuda")
    b[:, :NB] = torch.eye(NB, device="cuda")
    k3 = time_ms(lambda: K.trsm_left_lower(l, b), reps=5)
    lib = time_ms(lambda: torch.linalg.solve_triangular(l, b, upper=False),
                  reps=5)
    bd = bound(NB * NB * N, (NB * (NB + 1) / 2 + 2 * NB * N) * 4)
    say(f"  trsm_left_lower B=[{NB},{N}] (trtri's identity block row): "
        f"kernel_ms {k3:.4f}, solve_triangular_ms {lib:.4f}, bound_ms "
        f"{bd[0]:.4f} ({bd[1]})")


def phase_potrf_32k():
    """potrf at n = 32768, nb = 1024 at bf16_3x and bf16_6x, the port's
    counterpart of the JAX bench's potrf_3x_32k: GFLOP/s at n³/3 (best
    of two runs a tier, alternating), info 0, and the two factors within
    1e-3 of each other."""
    import slate_tpu_torch as st
    n = 2 * N
    gen = torch.Generator(device="cuda").manual_seed(45)
    a = torch.randn(n, n, generator=gen, device="cuda")
    a = a.add_(a.mT.clone()).mul_(0.5)
    a.diagonal().add_(3 * n ** 0.5)      # eigenvalues in [1.6√n, 4.4√n]
    A = st.HermitianMatrix.from_dense(a, nb=NB, grid=st.Grid(1, 1))
    del a
    best, factors = {}, {}
    for tier in ("bf16_6x", "bf16_3x") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L, info = st.potrf(A, {st.Option.TrailingPrecision: tier})
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        assert int(info) == 0, (tier, int(info))
        best[tier] = min(best.get(tier, t), t)
        factors[tier] = L.data
        del L
    diff = rel_err(factors["bf16_3x"], factors["bf16_6x"])
    say(f"potrf n={n} nb={NB}: " + ", ".join(
        f"{t} {best[t] * 1e3:.1f} ms ({n ** 3 / 3 / best[t] / 1e9:.1f} "
        f"GFLOP/s at n^3/3)" for t in best) + f"; bf16_3x/bf16_6x "
        f"{best['bf16_6x'] / best['bf16_3x']:.2f}x; factors rel_err "
        f"{diff:.3e} (tol 1e-3)")
    assert diff <= 1e-3


def phase_mixed_failure_report():
    """4f: a non-SPD posv_mixed reports info > 0 and the fallback; a
    singular gesv_mixed info > 0; potrf(health=True) on a non-SPD
    matrix names the first bad tile and no growth."""
    import slate_tpu_torch as st
    from slate_tpu_torch.linalg import mixed
    n, nb = 512, 128
    grid = st.Grid(1, 1)
    rng = np.random.default_rng(46)
    g = rng.standard_normal((n, n))
    s = (g @ g.T / n + np.eye(n)).astype(np.float32)
    s[300, 300] = -100.0                  # block column 2 (0-based) fails
    b = rng.standard_normal((n, 2)).astype(np.float32)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    _, iters, info = st.posv_mixed(
        st.HermitianMatrix.from_dense(s, nb=nb, grid=grid), B)
    fell_back = mixed.used_fallback()
    a = (rng.standard_normal((n, n)) + n ** 0.5 * np.eye(n)).astype(np.float32)
    a[:, 17] = 0.0
    _, giters, ginfo = st.gesv_mixed(st.Matrix.from_dense(a, nb=nb, grid=grid),
                                     B)
    _, rep = st.potrf(st.HermitianMatrix.from_dense(s, nb=nb, grid=grid),
                      health=True)
    say(f"mixed failure report n={n}: non-SPD posv_mixed info {int(info)}, "
        f"iters {iters}, fallback {fell_back}; singular gesv_mixed info "
        f"{int(ginfo)}, iters {giters}; potrf(health=True) info "
        f"{rep.info}, first_bad_tile {rep.first_bad_tile}, growth "
        f"{rep.growth}")
    assert int(info) > 0 and fell_back and iters == IR_ITERMAX
    assert int(ginfo) > 0
    assert rep.info == 3 and rep.first_bad_tile == (2, 2)
    assert rep.growth is None


# ---------------------------------------------------------------------------
# the Level-3 BLAS, band BLAS, band Cholesky and hegv slice
# ---------------------------------------------------------------------------

def quiet_path(fn):
    """``fn()`` with the launch counts set to 0 just before it; none of
    the port's kernels may run."""
    from slate_tpu_torch.internal import kernels as K
    torch.cuda.synchronize()
    K.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    ran = {k: v for k, v in K.LAUNCHES.items() if v}
    assert not ran, f"no kernel expected, launched {ran}"
    return out


def check_product(label, fn, ref64, k, lib):
    """One product on the card: error relative to the f64 product
    ‖C − C64‖_F/‖C64‖_F within 10·k·2⁻²⁴ (k the contraction) and within
    16·√k·2⁻²⁴, its time and the time of the library expression ``lib``
    (TF32 off) on the mirrored dense operands (medians of 3). The second
    bound: rounding errors of random sign grow as √k, so an FP32 product
    stays well inside it, while rounding the operands to TF32 or bf16
    alone costs 2⁻¹¹ or more of relative error."""
    out = quiet_path(fn).to_dense()
    err = rel_err(out, ref64)
    limit = 10 * k * 2.0 ** -24
    tight = 16 * k ** 0.5 * 2.0 ** -24
    ms = time_ms(fn, reps=3)
    with _f32():
        lib_ms = time_ms(lib, reps=3)
    say(f"  {label}: ms {ms:.3f}, matmul_ms {lib_ms:.3f}, rel_err {err:.3e} "
        f"(bound {limit:.3e}, tight {tight:.3e})")
    assert bool(torch.isfinite(out).all()) and err <= min(limit, tight), \
        (label, err)


def phase_blas3():
    """3r (dense): hemm and symm on both sides and both uplos, her2k and
    syr2k, trmm on both sides, Lower/Upper, unit and not, f32 at
    n = 16384, nb = 1024 against [n, 1024] operands."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, nb, k = N, NB, NB
    gen = torch.Generator(device="cuda").manual_seed(50)
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, k, generator=gen, device="cuda")
    b2 = torch.randn(n, k, generator=gen, device="cuda")
    bt = b.T.contiguous()
    a64, b64, b2_64, bt64 = a.double(), b.double(), b2.double(), bt.double()
    B, B2, Bt = (st.Matrix.from_dense(x, nb=nb, grid=grid) for x in (b, b2, bt))
    C, Ct = st.Matrix.zeros(n, k, nb, grid), st.Matrix.zeros(k, n, nb, grid)
    say(f"Level-3 BLAS f32 n={n} nb={nb} Grid(1,1), B [{n}, {k}] (Right: "
        f"its transpose); error against the f64 product formed on the card")
    for uplo in ("Lower", "Upper"):
        lower = uplo == "Lower"
        half = a64.tril() if lower else a64.triu()
        full64 = half + (half.tril(-1) if lower else half.triu(1)).T
        full = full64.float()
        for cls, fn in ((st.HermitianMatrix, st.hemm),
                        (st.SymmetricMatrix, st.symm)):
            A = cls.from_dense(a, nb=nb, grid=grid, uplo=st.Uplo[uplo])
            check_product(f"{fn.__name__} Left {uplo}",
                          lambda: fn(st.Side.Left, 1.0, A, B, 0.0, C),
                          full64 @ b64, n, lambda: full @ b)
            check_product(f"{fn.__name__} Right {uplo}",
                          lambda: fn(st.Side.Right, 1.0, A, Bt, 0.0, Ct),
                          bt64 @ full64, n, lambda: bt @ full)
            del A
        del half, full64, full
    ref = b64 @ b2_64.T
    ref += b2_64 @ b64.T
    for cls, fn in ((st.HermitianMatrix, st.her2k), (st.SymmetricMatrix,
                                                     st.syr2k)):
        G = cls.zeros(n, n, nb, grid)
        check_product(fn.__name__, lambda: fn(1.0, B, B2, 0.0, G), ref, k,
                      lambda: torch.addmm(b @ b2.T, b2, b.T))
        del G
    del ref
    for uplo in ("Lower", "Upper"):
        for diag in ("NonUnit", "Unit"):
            t64 = a64.tril() if uplo == "Lower" else a64.triu()
            if diag == "Unit":
                t64.fill_diagonal_(1.0)
            t = t64.float()
            T = st.TriangularMatrix.from_dense(a, nb=nb, grid=grid,
                                               uplo=st.Uplo[uplo],
                                               diag=st.Diag[diag])
            check_product(f"trmm Left {uplo} {diag}",
                          lambda: st.trmm(st.Side.Left, 1.0, T, B),
                          t64 @ b64, n, lambda: t @ b)
            check_product(f"trmm Right {uplo} {diag}",
                          lambda: st.trmm(st.Side.Right, 1.0, T, Bt),
                          bt64 @ t64, n, lambda: bt @ t)
            del T, t, t64


def band_solve_residual(t64, x, b, right=False) -> float:
    """‖T·X − B‖_F/(‖T‖_F·‖X‖_F) (X·T on the right) in f64 on the card."""
    x64, b64 = x.double(), b.double()
    r = (x64 @ t64 if right else t64 @ x64) - b64
    return float(torch.linalg.norm(r) / (torch.linalg.norm(t64)
                                         * torch.linalg.norm(x64)))


def phase_band_blas():
    """3r (band): gbmm, hbmm on both sides and tbsm on both sides, lower
    and upper, and with pivots, at 3m's band (n = 16384, kl = ku = 32,
    storage nb = 256, nrhs = 8)."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, kd, nb = N, BAND_KL, AASEN_NB
    gen = torch.Generator(device="cuda").manual_seed(51)
    a = band_matrix(n, kd, kd, 52)
    h = (a + a.T) / 2
    t = a.tril()
    t.diagonal().copy_(t.abs().sum(1) + 1.0)   # diagonally dominant
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    bt = b.T.contiguous()
    piv = torch.clamp(torch.arange(n, device="cuda") + torch.randint(
        0, kd + 1, (n,), generator=gen, device="cuda"), max=n - 1)
    piv = piv.int().reshape(n // nb, nb)
    a64, h64, t64, b64, bt64 = (x.double() for x in (a, h, t, b, bt))
    A = st.BandMatrix.from_dense(a, nb=nb, grid=grid, kl=kd, ku=kd)
    H = st.HermitianBandMatrix.from_dense(h.tril(), nb=nb, grid=grid, kl=kd,
                                          ku=kd)
    T = st.TriangularBandMatrix.from_dense(t, nb=nb, grid=grid, kl=kd, ku=0)
    U = st.TriangularBandMatrix.from_dense(t.T.contiguous(), nb=nb,
                                           grid=grid, kl=0, ku=kd,
                                           uplo=st.Uplo.Upper)
    B, Bt = (st.Matrix.from_dense(x, nb=nb, grid=grid) for x in (b, bt))
    C, Ct = (st.Matrix.zeros(n, NRHS, nb, grid),
             st.Matrix.zeros(NRHS, n, nb, grid))
    say(f"band BLAS f32 n={n} kl=ku={kd} nb={nb} nrhs={NRHS} Grid(1,1)")
    with _f32():
        dense_ms = time_ms(lambda: a @ b, reps=3)
    say(f"  dense matmul of the band as [n, n] (yardstick) {dense_ms:.3f} ms")
    limit = 10 * (2 * kd + 1) * 2.0 ** -24
    for label, fn, ref in (
            ("gbmm", lambda: st.gbmm(1.0, A, B, 0.0, C), a64 @ b64),
            ("hbmm Left", lambda: st.hbmm(st.Side.Left, 1.0, H, B, 0.0, C),
             h64 @ b64),
            ("hbmm Right", lambda: st.hbmm(st.Side.Right, 1.0, H, Bt, 0.0,
                                           Ct), bt64 @ h64)):
        out = quiet_path(fn).to_dense()
        err = rel_err(out, ref)
        ms = time_ms(fn, reps=3)
        say(f"  {label}: ms {ms:.3f}, rel_err {err:.3e} (bound {limit:.3e})")
        assert bool(torch.isfinite(out).all()) and err <= limit, (label, err)
    counts = {}
    nbw = 32                                     # the band block of kd = 32
    k3 = {"trsm_left_lower": n // nbw}
    limit, tight = 10 * n * 2.0 ** -24, 2.0 ** -24
    pb = b[_sim_perm_host(piv, n)]
    for label, fn, t_ref, rhs, right, expect in (
            ("tbsm Left Lower", lambda: st.tbsm(st.Side.Left, 1.0, T, B),
             t64, b, False, k3),
            ("tbsm Left Upper", lambda: st.tbsm(st.Side.Left, 1.0, U, B),
             t64.T, b, False, {}),
            ("tbsm Right Lower", lambda: st.tbsm(st.Side.Right, 1.0, T, Bt),
             t64, bt, True, {}),
            ("tbsm Right Upper", lambda: st.tbsm(st.Side.Right, 1.0, U, Bt),
             t64.T, bt, True, {}),
            ("tbsm Left Lower pivots", lambda: st.tbsm(
                st.Side.Left, 1.0, T, B, pivots=piv), t64, pb, False, k3)):
        fn()                                     # warm-up
        base, t0 = start_path()
        X = fn()
        ms, launches, _ = end_path(base, t0, expect)
        counts[label] = launches
        r = band_solve_residual(t_ref, X.to_dense(), rhs, right)
        say(f"  {label}: ms {ms:.3f}, |TX - B|/(|T||X|) {r:.3e} (bound "
            f"{limit:.3e}, tight {tight:.3e})")
        assert r <= min(limit, tight), (label, r)
    return counts


def _sim_perm_host(piv, n):
    """The row order that LAPACK swaps ``piv`` (0-based, in order) give:
    B's row i after them is row ``perm[i]`` before."""
    perm = list(range(n))
    for i, p in enumerate(piv.reshape(-1).tolist()[:n]):
        perm[i], perm[p] = perm[p], perm[i]
    return torch.tensor(perm, device="cuda")


def spd_band(n, kd, seed):
    """A symmetric band of half-width kd, Gaussian off the diagonal, its
    diagonal 1 + its row's absolute sum: SPD by diagonal dominance."""
    s = band_matrix(n, kd, kd, seed)
    s = (s + s.T) / 2
    s.diagonal().copy_(s.abs().sum(1) + 1.0)
    return s


def phase_pbsv():
    """3r (pbsv): band Cholesky at n = 16384, kd = 32, nrhs = 8: info 0,
    the residual within 10·n·2⁻²⁴ and 2⁻²⁴, K1, K2 and K3 once a band
    block (512 each), ``pbtrf_ms``, ``pbsv_ms`` beside the dense
    cholesky + cholesky_solve of the same matrix."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, kd, nb = N, PB_KD, AASEN_NB
    s = spd_band(n, kd, 53)
    b = torch.randn(n, NRHS, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(54))
    A = st.HermitianBandMatrix.from_dense(s.tril(), nb=nb, grid=grid, kl=kd,
                                          ku=kd)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    st.pbsv(st.HermitianBandMatrix.from_dense(s[:1024, :1024].tril(), nb=nb,
                                              grid=grid, kl=kd, ku=kd),
            st.Matrix.from_dense(b[:1024], nb=nb, grid=grid))   # warm-up
    blocks = n // 32                             # the band block of kd = 32
    base, t0 = start_path()
    X, L, info = st.pbsv(A, B)
    ms, launches, peak_gib = end_path(base, t0, {
        "potrf_tile": blocks, "trsm_right_lower_t": blocks,
        "trsm_left_lower": blocks})
    t1 = time.perf_counter()
    st.pbtrf(A)
    torch.cuda.synchronize()
    pbtrf_ms = (time.perf_counter() - t1) * 1e3
    with _f32():
        torch.linalg.cholesky(s[:1024, :1024])          # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lc = torch.linalg.cholesky(s)
        torch.cholesky_solve(b, lc)
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t1) * 1e3
    del lc
    info = int(info)
    x = X.to_dense()
    r = band_solve_residual(s.double(), x, b)
    limit, tight = 10 * n * 2.0 ** -24, 2.0 ** -24
    say(f"band Cholesky: pbsv f32 n={n} kd={kd} (band block 32, {blocks} "
        f"blocks) nrhs={NRHS} Grid(1,1): info {info}, |AX - B|/(|A||X|) "
        f"{r:.3e} (bound {limit:.3e}, tight {tight:.3e})")
    say(f"  pbtrf_ms {pbtrf_ms:.3f}, pbsv_ms {ms:.3f}, peak device memory "
        f"above its inputs {peak_gib:.3f} GiB; dense cholesky + "
        f"cholesky_solve f32 (yardstick) {dense_ms:.3f} ms")
    assert info == 0 and tuple(x.shape) == (n, NRHS)
    assert bool(torch.isfinite(x).all()) and r <= min(limit, tight), r
    return launches


def phase_hegv():
    """3r (hegv): itype 1, 2, 3 at 3i's shape (n = 4096, nb = 512, DC heev
    re-blocked to 128), A = (G + Gᵀ)/2, B = G₂·G₂ᵀ/n + I: λ and the
    generalised residual ‖R‖_F/‖Z‖_F within 10·n·2⁻²⁴·‖A‖₂·κ(B) of an
    f64 reference formed on the card, and within √n·2⁻²⁴·‖A‖₂·κ(B),
    which a TF32 or bf16 solve (2⁻¹¹·‖A‖₂ or more) exceeds; K1 8, K2 7
    (potrf of B), K3 8 (itype 1: hegst's left solve), K8 1."""
    import slate_tpu_torch as st
    grid = st.Grid(1, 1)
    n, nb = HEGV_N, HEGV_NB
    a = sym_matrix(n, 55)
    g = torch.randn(n, n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(56))
    with _f32():
        bm = g @ g.T / n + torch.eye(n, device="cuda")
    del g
    A = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid)
    Bh = st.HermitianMatrix.from_dense(bm, nb=nb, grid=grid)
    opts = {st.Option.MethodEig: st.MethodEig.DC}
    a64, b64 = a.double(), bm.double()
    l64 = torch.linalg.cholesky(b64)
    ev_b = torch.linalg.eigvalsh(b64)
    norm_a = float(torch.linalg.eigvalsh(a64).abs().max())
    kappa = float(ev_b[-1] / ev_b[0])
    limit = 10 * n * 2.0 ** -24 * norm_a * kappa
    tight = n ** 0.5 * 2.0 ** -24 * norm_a * kappa
    st.hegv(1, st.HermitianMatrix.from_dense(a[:512, :512], nb=128,
                                             grid=grid),
            st.HermitianMatrix.from_dense(bm[:512, :512], nb=128, grid=grid),
            opts)                                 # warm-up
    say(f"hegv f32 n={n} nb={nb} DC Grid(1,1): |A|_2 {norm_a:.3f}, "
        f"kappa(B) {kappa:.3f}; bound 10*n*2^-24*|A|_2*kappa(B) = "
        f"{limit:.3e}, tight sqrt(n)*2^-24*|A|_2*kappa(B) = {tight:.3e}")
    counts = {}
    nt = n // nb
    for itype in (1, 2, 3):
        expect = {"potrf_tile": nt, "trsm_right_lower_t": nt - 1,
                  "hb2st_vmem": 1}
        if itype == 1:
            expect["trsm_left_lower"] = nt
        base, t0 = start_path()
        lam, Z, info = st.hegv(itype, A, Bh, opts)
        ms, launches, peak_gib = end_path(base, t0, expect)
        counts[f"hegv{itype}"] = launches
        if itype == 1:
            y = torch.linalg.solve_triangular(l64, a64, upper=False)
            c64 = torch.linalg.solve_triangular(l64, y.T, upper=False)
        else:
            c64 = l64.T @ a64 @ l64
        ref = torch.linalg.eigvalsh(c64)
        err = float((lam.double() - ref).abs().max())
        z = Z.to_dense().double()
        lam64 = lam.double()
        if itype == 1:
            r = a64 @ z - (b64 @ z) * lam64
        else:
            r = (a64 @ (b64 @ z) if itype == 2 else b64 @ (a64 @ z)) \
                - z * lam64
        res = float(torch.linalg.norm(r) / torch.linalg.norm(z))
        say(f"  itype {itype}: info {int(info)}, hegv_ms {ms:.3f}, "
            f"max|lam - lam_ref| {err:.3e}, |R|_F/|Z|_F {res:.3e}, peak "
            f"device memory above its inputs {peak_gib:.3f} GiB")
        assert int(info) == 0 and tuple(z.shape) == (n, n)
        assert bool(torch.isfinite(z).all()), itype
        assert max(err, res) <= min(limit, tight), (itype, err, res)
    return counts


def phase_blas_band_hegv():
    """3r: the dense Level-3 BLAS, the band BLAS, pbsv and hegv."""
    phase_blas3()
    counts = phase_band_blas()
    counts["pbsv"] = phase_pbsv()
    counts.update(phase_hegv())
    return counts


def phase_band_hegv_failure_report():
    """4g: a band that is not positive definite gives pbtrf's info and,
    with ``health=True``, a report naming its first bad block; a B that
    is not positive definite gives hegv's info with NaN λ and Z; the
    card and the CPU agree."""
    import slate_tpu_torch as st
    n, kd, nb = 2048, PB_KD, AASEN_NB
    s = spd_band(n, kd, 57)
    s[700, 700] = -1e3                   # band block 700 // 32 + 1 = 22
    m = 512
    rng = np.random.default_rng(58)
    g = rng.standard_normal((m, m))
    a = ((g + g.T) / 2).astype(np.float32)
    bm = (g @ g.T / m + np.eye(m)).astype(np.float32)
    bm[300, 300] = -100.0                # block column 300 // 128 + 1 = 3
    out = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        A = st.HermitianBandMatrix.from_dense(s.tril().to(dev), nb=nb,
                                              grid=grid, kl=kd, ku=kd)
        F, info = st.pbtrf(A)
        _, rep = st.pbtrf(A, health=True)
        lam, Z, hinfo = st.hegv(1, st.HermitianMatrix.from_dense(
            a, nb=128, grid=grid), st.HermitianMatrix.from_dense(
            bm, nb=128, grid=grid))
        out[dev] = (int(info), rep.info, rep.first_bad_tile, rep.growth,
                    bool(torch.isfinite(F.ab).all()), int(hinfo),
                    bool(torch.isnan(lam).all()),
                    bool(torch.isnan(Z.to_dense()).all()))
    say(f"band Cholesky/hegv failure report: pbtrf info, health info, "
        f"first bad tile, growth, factor finite, hegv info, lam NaN, Z NaN: "
        f"card {out['cuda']}, CPU {out['cpu']}")
    assert out["cuda"] == out["cpu"] == (22, 22, (21, 21), None, True, 3,
                                         True, True)


# ---------------------------------------------------------------------------
# the LAPACK API, stein and CALU slice
# ---------------------------------------------------------------------------

STEIN_N = EIG_N           # K12 timed at heev's n = k = 8192
STEIN_CHECK_N = 1024      # K12 held to its plain version at n = k = 1024
SHIM_NB = 512             # lapack_api._default_nb at n = 16384
CALU_N = 32768            # the fast path's top, two-chunk tournaments
DENSE_N = 65536           # BASELINE.json's headline size (17.2 GB f32)


def stein_inputs(n, kind, dt, seed):
    """A symmetric tridiagonal (random, or clusters of 16 eigenvalues
    within ~1e-5 of each integer), its perturbed shifts and a start
    uniform in [0.5, 1), on the card."""
    from slate_tpu_torch.linalg import eig, stein
    rng = np.random.default_rng(seed)
    if kind == "random":
        d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    else:
        d = np.floor(np.arange(n) / 16.0) + 1e-7 * rng.standard_normal(n)
        e = 1e-5 * rng.standard_normal(n - 1)
    lam_p, _, _ = stein.shifts(d, e, eig.sterf(d, e), dt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.empty((n, n), dtype=dt, device="cuda").uniform_(
        0.5, 1.0, generator=gen)
    return [torch.tensor(v, dtype=dt, device="cuda") for v in (d, e, lam_p)
            ] + [x0]


def stein_bound(n, k, iters=2):
    """K12's least time: its inputs (X0, d, e, λ) read once and X written
    once, or its operations (a forward row ~11, a back row ~6, the
    renormalisation 2 a sweep; the 2-norm and sign 6), the larger."""
    flops = (iters * (11 + 6 + 2) + 6) * n * k
    return bound(flops, (2 * n * k + 3 * n) * 4)


def phase_stein_kernel():
    """2g: K12 against its plain version on the card at n = k = 1024, f32
    and f64, on a random and a clustered tridiagonal, and at n = k = 8192
    (f32, heev's shape; its max_abs_err is the row's); its time there
    beside the plain version's (one run: ~25 launches a row) and its
    bound."""
    from slate_tpu_torch.internal import kernels as K
    say("stein kernel (K12, batched inverse iteration) vs plain on the card:")
    for dt in (torch.float32, torch.float64):
        for kind in ("random", "clustered"):
            args = stein_inputs(STEIN_CHECK_N, kind, dt, 70)
            check("stein", lambda: K.stein_iter(*args, 2),
                  lambda: K.stein_iter_plain(*args, 2),
                  f"n=k={STEIN_CHECK_N} {str(dt)[6:]} {kind}")
    args = stein_inputs(STEIN_N, "random", torch.float32, 71)
    ms = time_ms(lambda: K.stein_iter(*args, 2))
    plain = {}

    def plain_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain["out"] = K.stein_iter_plain(*args, 2)
        torch.cuda.synchronize()
        plain["ms"] = (time.perf_counter() - t0) * 1e3
        return plain["out"]
    # the main path's shape (heev QR at 8192): the kernel held to the
    # plain version's one run, which is also its time
    mx = check("stein", lambda: K.stein_iter(*args, 2), plain_run,
               f"n=k={STEIN_N} float32 random")
    plain_ms = plain["ms"]
    bnd = stein_bound(STEIN_N, STEIN_N)
    traffic = 28 * STEIN_N * STEIN_N * 4 / HBM_RATE * 1e3
    say(f"  stein n=k={STEIN_N} f32: kernel_ms {ms:.4f}, plain_ms "
        f"{plain_ms:.1f} (one run), bound_ms {bnd[0]:.4f} ({bnd[1]}); the "
        f"design's own traffic (28·n·k·4 B: fill rows written and read "
        f"back, two sweeps) over 3.35 TB/s {traffic:.4f} ms")
    return {"stein": dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound=bnd)}


def lu_fast_counts(n, nb, hmax=16384, w=128, group=4):
    """The K4/K5 launches of the pivoting-by-index LU at n, nb
    (``linalg/getrf._getrf_fast_group_core``): per group, subpanels
    taller than H_MAX through plu_panel's tournament (a folded
    plu_subpanel per H_MAX chunk and one final round on the winners),
    the folded branch where the window is a multiple of 1024 rows, the
    flat branch otherwise."""
    c = dict.fromkeys(("plu_call", "plu_call_folded", "plu_call_folded_block",
                       "transpose_tiled", "transpose_fold", "fold_panel",
                       "unfold_panel", "unfold_transpose"), 0)

    def subpanel(h, times):
        if h % 1024 == 0:
            for k in ("transpose_fold", "plu_call_folded",
                      "unfold_transpose"):
                c[k] += times
        else:
            c["transpose_tiled"] += 2 * times
            c["plu_call"] += times

    kt = n // nb
    for g0 in range(0, kt, group):
        gsz = min(group, kt - g0)
        hw = n - g0 * nb
        subs = gsz * (nb // w)
        if hw > hmax:
            nch = -(-hw // hmax)
            subpanel(hmax, subs * nch)
            subpanel(max(nch * w, 8), subs)
        elif hw % 1024 == 0:
            c["fold_panel"] += gsz
            c["unfold_panel"] += gsz
            c["plu_call_folded_block"] += subs
        else:
            c["transpose_tiled"] += 2 * gsz
            c["plu_call"] += subs
    return {k: v for k, v in c.items() if v}


def solve_residual(a, x, b):
    """‖A·X − B‖_F/(‖A‖_F·‖X‖_F), FP32 products on the card."""
    with _f32():
        return float(torch.linalg.norm(a @ x - b)
                     / (torch.linalg.norm(a) * torch.linalg.norm(x)))


def shim_call(label, api, shim, expect):
    """The Matrix-API call (a warm-up, then timed, not counted), then the
    shim on numpy (timed, launch counts exact); prints both times."""
    api()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api()
    torch.cuda.synchronize()
    api_ms = (time.perf_counter() - t0) * 1e3
    base, t0 = start_path()
    out = shim()
    ms, launches, _ = end_path(base, t0, expect)
    say(f"  {label}: shim_ms {ms:.3f} (numpy in and out), Matrix API "
        f"{api_ms:.3f} ms")
    return out, launches


def phase_lapack_shims():
    """3s (a): the LAPACK shims on numpy input at full width, each beside
    the Matrix-API call it wraps, with exact launch counts and the bounds
    of the routine it wraps."""
    import slate_tpu_torch as st
    from slate_tpu_torch import lapack_api as la
    grid = st.Grid(1, 1)
    n, nb, nt = N, SHIM_NB, N // SHIM_NB
    gen = torch.Generator(device="cuda").manual_seed(72)
    g = torch.randn(n, n, generator=gen, device="cuda")
    with _f32():
        s = g @ g.T / n + torch.eye(n, device="cuda")
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    g_np, s_np, b_np = g.cpu().numpy(), s.cpu().numpy(), b.cpu().numpy()
    A = st.Matrix.from_dense(g, nb=nb, grid=grid)
    S = st.HermitianMatrix.from_dense(s, nb=nb, grid=grid)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    limit = 10 * n * 2.0 ** -24
    lu = lu_fast_counts(n, nb)
    chol = {"potrf_tile": nt, "trsm_right_lower_t": nt - 1}
    say(f"LAPACK API: shims on numpy f32 n={n} (nb {nb} by _default_nb), "
        f"nrhs={NRHS}, on Grid(1,1):")
    counts = {}
    res = {}
    (x, info), counts["sgesv"] = shim_call(
        "slate_sgesv", lambda: st.gesv(A, B),
        lambda: la.slate_sgesv(g_np, b_np), {**lu, "trsm_left_lower": nt})
    res["sgesv"] = (info, solve_residual(g, torch.from_numpy(x).cuda(), b))
    (x, info), counts["sposv"] = shim_call(
        "slate_sposv", lambda: st.posv(S, B),
        lambda: la.slate_sposv("L", s_np, b_np),
        {**chol, "trsm_left_lower": nt})
    res["sposv"] = (info, solve_residual(s, torch.from_numpy(x).cuda(), b))
    (l, info), counts["spotrf"] = shim_call(
        "slate_spotrf", lambda: st.potrf(S),
        lambda: la.slate_spotrf("L", s_np), chol)
    L = st.potrf(S)[0]
    x, counts["spotrs"] = shim_call(
        "slate_spotrs", lambda: st.potrs(L, B),
        lambda: la.slate_spotrs("L", l, b_np), {"trsm_left_lower": nt})
    res["spotrf+spotrs"] = (info, solve_residual(
        s, torch.from_numpy(x).cuda(), b))
    (lu_np, piv, info), counts["sgetrf"] = shim_call(
        "slate_sgetrf", lambda: st.getrf(A), lambda: la.slate_sgetrf(g_np),
        lu)
    assert piv.shape == (nt, nb) and piv.dtype == np.int32
    LU, piv_t, _ = st.getrf(A)
    assert np.array_equal(piv, piv_t.cpu().numpy()), "sgetrf pivots"
    x, counts["sgetrs"] = shim_call(
        "slate_sgetrs", lambda: st.getrs(LU, piv_t, B),
        lambda: la.slate_sgetrs("n", lu_np, piv.reshape(-1), b_np),
        {"trsm_left_lower": nt})
    res["sgetrf+sgetrs"] = (info, solve_residual(
        g, torch.from_numpy(x).cuda(), b))
    for name, (info, r) in res.items():
        say(f"  {name}: info {info}, |AX - B|/(|A||X|) {r:.3e} (bound "
            f"{limit:.3e})")
        assert info == 0 and r <= limit, (name, info, r)
    del S, L, LU, s, s_np, lu_np

    nd = n // 2                                  # dgesv at 8192
    a64 = g[:nd, :nd].double()
    a64_np, b64_np = a64.cpu().numpy(), b[:nd].double().cpu().numpy()
    A64 = st.Matrix.from_dense(a64, nb=nb, grid=grid)
    B64 = st.Matrix.from_dense(b[:nd].double(), nb=nb, grid=grid)
    (x, info), counts["dgesv"] = shim_call(
        f"slate_dgesv n={nd}", lambda: st.gesv(A64, B64),
        lambda: la.slate_dgesv(a64_np, b64_np), {})
    r = float(torch.linalg.norm(a64 @ torch.from_numpy(x).cuda()
                                - b[:nd].double())
              / (torch.linalg.norm(a64) * np.linalg.norm(x)))
    lim64 = 10 * nd * 2.0 ** -53
    say(f"  slate_dgesv: info {info}, |AX - B|/(|A||X|) {r:.3e} (bound "
        f"{lim64:.3e})")
    assert info == 0 and r <= lim64, r
    del A64, B64, a64

    m, k = n, n // 4                             # gels 16384 x 4096
    at = g[:, :k].contiguous()
    At = st.Matrix.from_dense(at, nb=nb, grid=grid)
    x, counts["sgels"] = shim_call(
        f"slate_sgels {m}x{k}", lambda: st.gels(At, B),
        lambda: la.slate_sgels(g_np[:, :k], b_np),
        {"potrf_tile": k // nb, "trsm_right_lower_t": k // nb - 1})
    r = normal_residual(at, torch.from_numpy(x).cuda(), b)
    lim = 10 * m * 2.0 ** -24
    say(f"  slate_sgels (CholQR, m >= 2n): |A^T(AX - B)|/(|A|(|A||X| + "
        f"|B|)) {r:.3e} (bound {lim:.3e})")
    assert tuple(x.shape) == (k, NRHS) and r <= lim, r
    del At, at

    w = NB                                       # [16384, 1024] operands
    c = torch.randn(n, w, generator=gen, device="cuda")
    c_np = c.cpu().numpy()
    C = st.Matrix.from_dense(c, nb=nb, grid=grid)
    Z0 = st.Matrix.zeros(n, w, nb, grid)
    out, counts["sgemm"] = shim_call(
        f"slate_sgemm [{n},{n}]x[{n},{w}]",
        lambda: st.gemm(1.0, A, C, 0.0, Z0),
        lambda: la.slate_sgemm("n", "n", 1.0, g_np, c_np, 0.0,
                               np.zeros((n, w), np.float32)), {})
    ref = g.double() @ c.double()
    err = float(torch.linalg.norm(torch.from_numpy(out).cuda().double() - ref)
                / torch.linalg.norm(ref))
    lim, tight = 10 * n * 2.0 ** -24, 16 * n ** 0.5 * 2.0 ** -24
    say(f"  slate_sgemm: |C - C64|/|C64| {err:.3e} (bounds {lim:.3e}, tight "
        f"{tight:.3e})")
    assert err <= min(lim, tight), err
    del ref
    t = torch.tril(g) / n
    t.diagonal().add_(1.0)
    t_np = t.cpu().numpy()
    T = st.TriangularMatrix.from_dense(t, nb=nb, grid=grid)
    x, counts["strsm"] = shim_call(
        f"slate_strsm [{n},{n}] \\ [{n},{w}]",
        lambda: st.trsm(st.Side.Left, 1.0, T, C),
        lambda: la.slate_strsm("L", "L", "N", "N", 1.0, t_np, c_np),
        {"trsm_left_lower": nt})
    r = solve_residual(t, torch.from_numpy(x).cuda(), c)
    say(f"  slate_strsm: |TX - B|/(|T||X|) {r:.3e} (bound {limit:.3e})")
    assert r <= limit, r
    del T, t, t_np, C, c, c_np

    g64 = g.double()
    for kind, ref in (("F", torch.linalg.norm(g64)),
                      ("1", g64.abs().sum(0).max()),
                      ("I", g64.abs().sum(1).max()),
                      ("M", g64.abs().max())):
        v, counts[f"slange {kind}"] = shim_call(
            f"slate_slange '{kind}'", lambda: st.norm(
                {"F": st.Norm.Fro, "1": st.Norm.One, "I": st.Norm.Inf,
                 "M": st.Norm.Max}[kind], A),
            lambda: la.slate_slange(kind, g_np), {})
        e = abs(v - float(ref)) / float(ref)
        say(f"    rel. error {e:.3e} (bound {n * 2.0 ** -24:.3e})")
        assert e <= n * 2.0 ** -24, (kind, e)
    del g64

    q = n // 4                                   # gesvd values 4096
    gq = g[:q, :q].contiguous()
    sv, counts["sgesvd"] = shim_call(
        f"slate_sgesvd('N','N') n={q}",
        lambda: st.gesvd(st.Matrix.from_dense(gq, nb=nb, grid=grid)),
        lambda: la.slate_sgesvd("N", "N", gq.cpu().numpy()), {})
    ref = torch.linalg.svdvals(gq.double())
    err = float((torch.from_numpy(sv[0]).cuda().double() - ref).abs().max()
                / ref[0])
    lim = 10 * q * 2.0 ** -24
    say(f"  slate_sgesvd: max|s - s_ref|/s_max {err:.3e} (bound {lim:.3e}), "
        f"info {sv[3]}")
    assert sv[1] is None and sv[2] is None and sv[3] == 0 and err <= lim
    return counts


def phase_heev_qr():
    """3s (b): heev with MethodEig.QR at n = 8192, nb = 128 (3h's shape,
    now with vectors): values by host QR iteration, vectors by K12 and
    the cluster QR; λ within 10·n·2⁻²⁴·‖A‖₂ of eigvalsh f64, residual
    and orthogonality within 10·n·2⁻²⁴; K8 1, K12 1. Then slate_ssyev('N')
    on the same matrix."""
    import slate_tpu_torch as st
    from slate_tpu_torch import lapack_api as la
    grid = st.Grid(1, 1)
    n, nb = EIG_N, EIG_NB
    a = sym_matrix(n, 73)
    A = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid)
    opts = {st.Option.MethodEig: st.MethodEig.QR}
    st.heev(st.HermitianMatrix.from_dense(a[:1024, :1024], nb=nb, grid=grid),
            opts)                                    # warm-up
    base, t0 = start_path()
    (lam, Z), times, split = timed_stages(lambda t: st.heev(A, opts, True, t))
    ms, launches, peak_gib = end_path(base, t0, {"hb2st_vmem": 1,
                                                 "stein": 1})
    a64 = a.double()
    ref = torch.linalg.eigvalsh(a64)
    norm2 = float(ref.abs().max())
    z = Z.to_dense().double()
    lam64 = lam.double()
    err = float((lam64 - ref).abs().max())
    res = float(torch.linalg.norm(a64 @ z - z * lam64)
                / torch.linalg.norm(a64))
    orth = float(torch.linalg.norm(z.T @ z - torch.eye(
        n, dtype=torch.float64, device="cuda")) / n)
    limit = 10 * n * 2.0 ** -24
    say(f"heev QR with vectors f32 n={n} nb={nb} Grid(1,1): max|lam - "
        f"lam_ref| {err:.3e} (bound {limit * norm2:.3e}), |AZ - ZL|_F/|A|_F "
        f"{res:.3e}, |Z^T Z - I|_F/n {orth:.3e} (bound {limit:.3e} each)")
    say(f"  heev_qr_ms {ms:.3f} (stage clock on), peak device memory above "
        f"its inputs {peak_gib:.3f} GiB; stage split ms: {split}; stein "
        f"{times['stein'] * 1e3:.3f} beside sterf {times['sterf'] * 1e3:.3f}")
    assert tuple(z.shape) == (n, n) and bool(torch.isfinite(z).all())
    assert err <= limit * norm2 and max(res, orth) <= limit, (err, res, orth)
    del z, Z
    a_np = a.cpu().numpy()
    (w, zz, info), _ = shim_call(
        f"slate_ssyev('N') n={n}", lambda: st.heev(
            st.HermitianMatrix.from_dense(a, nb=SHIM_NB, grid=grid),
            want_vectors=False), lambda: la.slate_ssyev("N", "L", a_np), {})
    e = float((torch.from_numpy(w).cuda().double() - ref).abs().max())
    say(f"  slate_ssyev: max|lam - lam_ref| {e:.3e} (bound "
        f"{limit * norm2:.3e}), info {info}")
    assert zz is None and info == 0 and e <= limit * norm2, e
    return launches


def lu_factor_error(a, lu, piv, rows=4096):
    """‖P·A − L·U‖_F/(n‖A‖_F) of a dense in-place LU, formed a block of
    ``rows`` rows at a time in FP32 (L·U is never held whole)."""
    from slate_tpu_torch import runtime
    n = a.shape[0]
    perm = torch.from_numpy(runtime.resolve_pivots(piv.cpu().numpy(), n)
                            ).to(a.device)
    sq = 0.0
    with _f32():
        for r0 in range(0, n, rows):
            r1 = min(r0 + rows, n)
            l = torch.tril(lu[r0:r1, :r1], r0 - 1)
            l[:, r0:r1].diagonal().fill_(1.0)
            d = a[perm[r0:r1]].clone()
            for k0 in range(0, r1, rows):
                k1 = min(k0 + rows, r1)
                u = lu[k0:k1].clone()
                u[:, :k1].copy_(torch.triu(u[:, :k1], k0))
                d.addmm_(l[:, k0:k1], u, alpha=-1)
                del u
            sq += float(torch.linalg.norm(d)) ** 2
            del l, d
        an = float(torch.linalg.norm(a))
    return sq ** 0.5 / (n * an)


def run_dense_entry(kind):
    """getrf_dense_inplace or potrf_dense_inplace at n = 65536, nb = 1024
    on the caller's 17.2 GB array: GFLOP/s, the peak memory added (at most
    a quarter of the array's bytes), exact launch counts, and the bounds:
    ‖P·A − L·U‖/(n‖A‖) ≤ 1e-5 (getrf) and ‖A·X − B‖/(‖A‖·‖X‖) ≤ 10·n·2⁻²⁴
    (X by two triangular solves on the factor, a copy of A kept)."""
    import slate_tpu_torch as st
    from slate_tpu_torch import runtime
    n, nb = DENSE_N, NB
    gen = torch.Generator(device="cuda").manual_seed(74)
    a = torch.empty(n, n, device="cuda")
    a.normal_(generator=gen)
    if kind == "potrf":
        # symmetric, SPD by diagonal dominance (off-diagonal row sums
        # ~0.8·√n against a diagonal of 2·√n)
        a.mul_(n ** -0.5)
        for i in range(0, n, nb):
            blk = a[i:i + nb, i:i + nb]
            blk.copy_(blk.tril() + blk.tril(-1).T)
            a[i:i + nb, i + nb:] = a[i + nb:, i:i + nb].T
        a.diagonal().add_(2.0 * n ** 0.5)
    a0 = a.clone()
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    nbytes = a.numel() * 4
    expect = (lu_fast_counts(n, nb) if kind == "getrf" else
              {"potrf_tile": n // nb, "trsm_right_lower_t": n // nb - 1})
    base, t0 = start_path()
    ptr = a.data_ptr()
    if kind == "getrf":
        out, piv, info = st.getrf_dense_inplace(a, nb=nb)
        flops = 2 * n ** 3 / 3
    else:
        out, info = st.potrf_dense_inplace(a, nb=nb)
        flops = n ** 3 / 3
    ms, launches, _ = end_path(base, t0, expect)
    peak = torch.cuda.max_memory_allocated() - base
    info = int(info)
    assert out.data_ptr() == ptr and info == 0, info
    say(f"{kind}_dense_inplace f32 n={n} nb={nb}: info {info}, "
        f"{kind}_dense_ms {ms:.1f} ({flops / ms / 1e6:.1f} GFLOP/s), peak "
        f"device memory added {peak / 2 ** 30:.3f} GiB beside the array's "
        f"{nbytes / 2 ** 30:.3f} GiB ({peak / nbytes:.4f}; bound 0.25)")
    assert peak <= 0.25 * nbytes, peak / nbytes
    with _f32():
        if kind == "getrf":
            perm = torch.from_numpy(runtime.resolve_pivots(
                piv.cpu().numpy(), n)).to(a.device)
            y = torch.linalg.solve_triangular(out, b[perm], upper=False,
                                              unitriangular=True)
            x = torch.linalg.solve_triangular(out, y, upper=True)
        else:
            y = torch.linalg.solve_triangular(out, b, upper=False)
            x = torch.linalg.solve_triangular(out.mT, y, upper=True)
        r = solve_residual(a0, x, b)
    limit = 10 * n * 2.0 ** -24
    msg = f"  |AX - B|/(|A||X|) {r:.3e} (bound {limit:.3e})"
    if kind == "getrf":
        f = lu_factor_error(a0, out, piv)
        lmax = float(torch.tril(out, -1).abs().max())
        msg += (f", |PA-LU|/(n|A|) {f:.3e} (bound 1e-5), max|L| {lmax:.6f} "
                f"(CALU, no bound)")
        assert f <= 1e-5, f
    say(msg)
    assert bool(torch.isfinite(x).all()) and r <= limit, r
    return launches


def phase_calu_dense():
    """3s (c): gesv at n = 32768, nb = 1024 on the tiled fast path (on by
    itself up to 32768; its first groups' subpanels take the two-chunk
    tournament), then the donated dense entries at n = 65536."""
    counts = {"gesv_32k": run_gesv(
        CALU_N, NB, 75, {**lu_fast_counts(CALU_N, NB),
                         "trsm_left_lower": CALU_N // NB},
        "CALU fast path", calu=True)}
    torch.cuda.empty_cache()
    for kind in ("getrf", "potrf"):
        counts[f"{kind}_dense"] = run_dense_entry(kind)
        torch.cuda.empty_cache()
    return counts


def phase_lapack_stein_calu():
    """3s: the LAPACK shims, heev QR through stein, CALU and the dense
    entries."""
    counts = timed("3s (a) LAPACK shims", phase_lapack_shims)
    counts["heev_qr"] = timed("3s (b) heev QR with stein", phase_heev_qr)
    counts.update(timed("3s (c) CALU and the dense entries",
                        phase_calu_dense))
    return counts


def phase_lapack_calu_failure_report():
    """4h: a singular slate_sgesv (n = 512) gives the same info on the
    card and the CPU, at the shim's default nb = 64 (the dense path) and
    at nb = 128 with the fast path forced on both devices; slate_zheev
    gives the CPU's λ within 10·n·2⁻⁵³·max|λ|;
    slate_sgetrs with another ipiv blocking raises; plu_panel's tournament
    (h = 18432 > H_MAX, two chunks) on a panel with a zero column gives
    the same pivots, info and zero multipliers on the card and the CPU."""
    import slate_tpu_torch as st
    from slate_tpu_torch import lapack_api as la
    from slate_tpu_torch.internal import panel_plu as pp
    rng = np.random.default_rng(76)
    n = 512
    a = rng.standard_normal((n, n)).astype(np.float32)
    a[:, 100] = 0.0
    b = rng.standard_normal((n, 2)).astype(np.float32)
    dense = {dev: la.slate_sgesv(a, b, grid=st.Grid(1, 1, device=dev))[1]
             for dev in ("cuda", "cpu")}
    os.environ["SLATE_LU_FAST"] = "1"
    try:
        infos = {dev: la.slate_sgesv(a, b, 128,
                                     grid=st.Grid(1, 1, device=dev))[1]
                 for dev in ("cuda", "cpu")}
    finally:
        os.environ.pop("SLATE_LU_FAST")
    raised = []
    zw = {dev: la.slate_zheev("N", "L", a.astype(np.complex128),
                              grid=st.Grid(1, 1, device=dev))[0]
          for dev in ("cuda", "cpu")}
    zerr = float(np.abs(zw["cuda"] - zw["cpu"]).max()
                 / np.abs(zw["cpu"]).max())
    lu, piv, _ = la.slate_sgetrf(a + np.eye(n, dtype=np.float32), nb=64)
    try:
        la.slate_sgetrs("n", lu, piv, b, nb=128)
    except st.SlateError as e:
        raised.append("pivot blocking" in str(e))
    h = pp.H_MAX + 2048
    sub = rng.standard_normal((h, pp.W)).astype(np.float32)
    sub[:, 7] = 0.0
    out = {}
    for dev in ("cuda", "cpu"):
        res = pp.plu_panel(torch.tensor(sub, device=dev),
                           torch.ones(h, device=dev))
        o, p_, act, info = (r.cpu() for r in res)
        zcol = torch.diagonal(o[p_.long()].triu()) == 0
        zero_mult = bool((o[act > 0][:, zcol] == 0).all())
        out[dev] = (o, p_, int(info), int(zcol.sum()), zero_mult)
    same = torch.equal(out["cuda"][1], out["cpu"][1])
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    say(f"LAPACK/CALU failure report: singular sgesv info card "
        f"{dense['cuda']}, CPU {dense['cpu']} (dense path, nb 64), card "
        f"{infos['cuda']}, CPU {infos['cpu']} (fast path, nb 128); "
        f"slate_zheev card vs CPU max|d lambda|/max|lambda| {zerr:.3e} "
        f"(bound {10 * n * 2.0 ** -53:.3e}); ipiv "
        f"blocking raises {raised}; tournament h={h} zero column: pivots "
        f"equal {same}, info card {out['cuda'][2]} CPU {out['cpu'][2]}, zero "
        f"pivots {out['cuda'][3]}, zero multipliers {out['cuda'][4]}, max "
        f"|card - CPU| {err:.3e}")
    assert dense["cuda"] == dense["cpu"] == 1
    assert infos["cuda"] == infos["cpu"] == 1 and raised == [True]
    assert zw["cpu"].dtype == np.float64 and zerr <= 10 * n * 2.0 ** -53
    assert same and out["cuda"][2:] == out["cpu"][2:] == (1, 1, True)
    assert err <= LU_ATOL


# ---------------------------------------------------------------------------
# the complex solvers and utils slice
# ---------------------------------------------------------------------------

CPLX_U = {torch.complex64: 2.0 ** -24, torch.complex128: 2.0 ** -53}
GEN_N, GEN_NB = 4096, 256     # 2h: every kind on the card and on the CPU
GEN_STRUCT_N = 2048           # 2h: the structured kinds (host numpy QR)
GEN_TOL = 8 * 2.0 ** -24      # 2h: randn and formula kinds, card vs CPU
HESV_C_N = 8192               # 3t: hesv at 8192/256
SHIM_C_N = 8192               # 3t: the c/z shims


def crandn(gen, *shape, dtype=torch.complex64):
    """Complex Gaussian on the card, O(1) real and imaginary parts."""
    return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)


def crel_err(x, ref) -> float:
    """‖x − ref‖_F/‖ref‖_F in complex128 (``rel_err`` takes real parts)."""
    x, ref = x.to(torch.complex128), ref.to(torch.complex128)
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def cresidual(a, x, b) -> float:
    """‖A·X − B‖_F/(‖A‖_F·‖X‖_F) in complex128 on the card."""
    a, x, b = (t.to(torch.complex128) for t in (a, x, b))
    return float(torch.linalg.norm(a @ x - b)
                 / (torch.linalg.norm(a) * torch.linalg.norm(x)))


def solution_info(out):
    """``(X, info)`` of a driver's ``(X, …, info)``."""
    return out[0], out[-1]


# 3t's second bound: a complex64 path's ‖A·X − B‖/(‖A‖·‖X‖) stays within
# TF32_TIGHT[path]. Each bound sits near the geometric mean of two readings
# on an H100 (NVIDIA H100 80GB HBM3, 700 W): the path at full FP32, which
# read 3.4–21× below it, and the same path with the port's FP32 pins
# removed, which read 4.4–32× above it and which 3t runs beside it as the
# control. The first bound, 10·n·u, passes a TF32 result.
TF32_TIGHT = {"posv": 2e-8, "gesv": 3e-5, "gesv_nopiv": 4e-9,
              "gels": 4e-7, "hesv": 6e-4, "gbsv": 1e-7, "pbsv": 8e-9,
              "hegst": 7e-10, "slate_cgesv": 2e-5, "slate_cgels": 6e-7,
              # 3u's complex64 two-stage paths, by each path's reading:
              # pinned 1.6e-7–4.5e-6, pins removed 230–395× that
              "heev_vals": 3e-6, "gesvd_vals": 2.5e-6, "heev": 8e-5,
              "gesvd": 8.5e-5, "hegv1": 9e-6, "hegv2": 1.7e-5,
              "hegv3": 1.9e-5}


@contextlib.contextmanager
def fp32_pins_removed():
    """The control of 3t's second bound: every FP32 pin of the port
    (``precision.full_f32_matmul``, which the tier contexts use too)
    leaves TF32 on, so a complex64 product inside one runs in TF32."""
    from slate_tpu_torch.internal import precision
    pin = precision._tf32_flag
    precision._tf32_flag = lambda on: pin(True)
    try:
        yield
    finally:
        precision._tf32_flag = pin


def hold_second_bound(key, res, res_control):
    """The pinned reading within TF32_TIGHT[key], the control above it."""
    tight = TF32_TIGHT[key]
    say(f"    second bound {tight:.1e}: pinned {res:.3e}, pins removed "
        f"{res_control:.3e} ({res_control / tight:.1f}x the bound)")
    assert res <= tight < res_control, (key, res, tight, res_control)


def complex_path(label, fn, dtype, n, check, key=None):
    """One complex path on the card: the launch counts set to 0 just
    before it and none of K1–K12 launched just after; its time (one run),
    ``info`` and ‖A·X − B‖/(‖A‖·‖X‖) ≤ 10·n·u (u the dtype's unit
    roundoff). ``fn`` returns ``(out, info)``; ``check(out)`` the
    residual and any extra bound as ``(res, extra_text)``. A complex64
    path with a ``key`` runs again with the FP32 pins removed, and
    :func:`hold_second_bound` holds both residuals to TF32_TIGHT[key]."""
    base, t0 = start_path()
    out, info = fn()
    ms, _, peak_gib = end_path(base, t0, {})
    info = int(info)
    res, extra = check(out)
    limit = 10 * n * CPLX_U[dtype]
    say(f"  {label} {str(dtype)[6:]}: ms {ms:.3f}, info {info}, residual "
        f"{res:.3e} (bound 10*n*u = {limit:.3e}; {res / CPLX_U[dtype]:.1f} u)"
        f"{extra}, peak device memory above its inputs {peak_gib:.3f} GiB")
    assert info == 0 and res <= limit, (label, info, res)
    if key is not None:
        with fp32_pins_removed():
            control, _ = fn()
        hold_second_bound(key, res, check(control)[0])
    return out


def phase_complex_product():
    """3t (the second bound): the port's complex64 ``gemm`` at
    [16384, 16384]·[16384, 1024] with TF32 turned on by the caller, held
    to 16·√k·2⁻²⁴ of the complex128 product formed on the card (a TF32
    product, 2⁻¹¹ a rounding, lands above it); no kernel launched; beside
    it ``torch.matmul`` of the same complex64 operands with TF32 on and
    off, whose errors show whether cuBLAS takes TF32 for complex64."""
    import slate_tpu_torch as st
    from slate_tpu_torch.internal.precision import tf32_matmul
    grid = st.Grid(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(90)
    a, b = crandn(gen, N, N), crandn(gen, N, NB)
    ref = a.to(torch.complex128) @ b.to(torch.complex128)
    A, B = (st.Matrix.from_dense(t, nb=NB, grid=grid) for t in (a, b))
    C = st.Matrix.zeros(N, NB, NB, grid, dtype=torch.complex64)
    tight = 16 * N ** 0.5 * 2.0 ** -24
    with tf32_matmul():
        out = quiet_path(lambda: st.gemm(1.0, A, B, 0.0, C)).to_dense()
        ms = time_ms(lambda: st.gemm(1.0, A, B, 0.0, C), reps=3)
        lib_tf32 = crel_err(a @ b, ref)
    with _f32():
        lib_ms = time_ms(lambda: a @ b, reps=3)
        lib_fp32 = crel_err(a @ b, ref)
    err = crel_err(out, ref)
    say(f"  complex64 gemm [{N}, {N}]x[{N}, {NB}], caller's TF32 on: ms "
        f"{ms:.3f}, rel_err {err:.3e} (bound 16*sqrt(k)*2^-24 = {tight:.3e})"
        f"; torch.matmul ms {lib_ms:.3f}, rel_err TF32 off {lib_fp32:.3e}, "
        f"TF32 on {lib_tf32:.3e}")
    assert bool(torch.isfinite(out).all()) and err <= tight, err


def phase_complex_solvers():
    """3t: the complex solvers at full width on the card (complex64 unless
    marked), every path with the caller's TF32 on."""
    import slate_tpu_torch as st
    from slate_tpu_torch import lapack_api as la
    from slate_tpu_torch.internal.precision import tf32_matmul
    from slate_tpu_torch.linalg import mixed
    grid = st.Grid(1, 1)
    c64, c128 = torch.complex64, torch.complex128
    gen = torch.Generator(device="cuda").manual_seed(91)
    M = lambda t, cls=st.Matrix, nb=NB, **kw: cls.from_dense(
        t, nb=nb, grid=grid, **kw)
    eye = torch.eye(N, device="cuda")
    say(f"complex solvers on Grid(1,1), n={N} nb={NB} nrhs={NRHS} unless "
        f"given; the caller's TF32 on; A·X − B against 10·n·u")
    phase_complex_product()
    with tf32_matmul():
        g = crandn(gen, N, N)
        h = (g + g.mH) / 2
        hpd = h + 4 * N ** 0.5 * eye          # κ ≈ 2.2
        b = crandn(gen, N, NRHS)
        B = M(b)
        S = M(hpd, st.HermitianMatrix)
        complex_path("posv", lambda: solution_info(st.posv(S, B)), c64, N,
                     lambda X: (cresidual(hpd, X.to_dense(), b), ""),
                     "posv")
        del S
        A = M(g)
        complex_path("gesv", lambda: solution_info(st.gesv(A, B)),
                     c64, N, lambda X: (cresidual(g, X.to_dense(), b), ""),
                     "gesv")
        del A
        dom = g + N * eye
        D = M(dom)
        complex_path("gesv_nopiv",
                     lambda: solution_info(st.gesv_nopiv(D, B)), c64, N,
                     lambda X: (cresidual(dom, X.to_dense(), b), ""),
                     "gesv_nopiv")
        del D, dom, h
        m, n = QR_M, QR_N
        a = g[:, :n].contiguous()
        x0 = crandn(gen, n, NRHS)
        b0 = (a.to(c128) @ x0.to(c128)).to(c64)
        A, Bq = M(a), M(b0)
        qr_opts = {st.Option.MethodGels: st.MethodGels.Geqrf}

        def qr_check(X):
            QR, T = st.geqrf(A)
            R = torch.zeros(m, n, dtype=c64, device="cuda")
            R[:n] = QR.to_dense()[:n].triu()
            QRp = st.unmqr(st.Side.Left, st.Op.NoTrans, QR, T,
                           M(R)).to_dense()
            err = crel_err(QRp, a)
            assert err <= 10 * m * 2.0 ** -24, err
            return (cresidual(a, X.to_dense(), b0),
                    f", |A - QR|_F/|A|_F {err:.3e} (bound 10*m*2^-24)")
        complex_path(f"gels {m}x{n} (Householder, B = A·X0)",
                     lambda: (st.gels(A, Bq, qr_opts), 0), c64, m,
                     qr_check, "gels")
        del A, Bq, a, g
        nh = HESV_C_N
        gh = crandn(gen, nh, nh)
        hh = (gh + gh.mH) / 2
        bh = crandn(gen, nh, NRHS)
        Hh = M(hh.tril(), st.HermitianMatrix, nb=AASEN_NB)
        complex_path(f"hesv n={nh} nb={AASEN_NB}",
                     lambda: solution_info(st.hesv(Hh, M(bh, nb=AASEN_NB))),
                     c64, nh,
                     lambda X: (cresidual(hh, X.to_dense(), bh), ""),
                     "hesv")
        del Hh, gh
        i = torch.arange(N, device="cuda")
        inband = (i[None, :] - i[:, None]).abs() <= BAND_KL
        band = torch.where(inband, crandn(gen, N, N), 0)
        Bb = M(b, nb=AASEN_NB)
        complex_path(f"gbsv kl=ku={BAND_KL}",
                     lambda: solution_info(st.gbsv(
                         M(band, st.BandMatrix, nb=AASEN_NB, kl=BAND_KL,
                           ku=BAND_KU), Bb)),
                     c64, N, lambda X: (cresidual(band, X.to_dense(), b), ""),
                     "gbsv")
        hb = (band + band.mH) / 2 + 4 * (2 * PB_KD + 1) * eye
        hb = torch.where((i[None, :] - i[:, None]).abs() <= PB_KD, hb, 0)
        complex_path(f"pbsv kd={PB_KD}",
                     lambda: solution_info(st.pbsv(
                         M(hb.tril(), st.HermitianBandMatrix, nb=AASEN_NB,
                           kl=PB_KD, ku=PB_KD), Bb)),
                     c64, N, lambda X: (cresidual(hb, X.to_dense(), b), ""),
                     "pbsv")
        del band, hb, Bb
        ng, nbg = HEGV_N, HEGV_NB
        ga, gb = crandn(gen, ng, ng), crandn(gen, ng, ng)
        ha = (ga + ga.mH) / 2
        hbm = (gb + gb.mH) / 2 + 4 * ng ** 0.5 * torch.eye(ng, device="cuda")
        L, info = st.potrf(M(hbm, st.HermitianMatrix, nb=nbg))
        assert int(info) == 0
        l = L.to_dense().tril()

        def hegst_check(C):
            # L·C·Lᴴ = A, held as A·X = B with X = C
            c = C.to_dense()
            lc = l.to(c128) @ c.to(c128)
            return (float(torch.linalg.norm(lc @ l.mH.to(c128) - ha)
                          / (torch.linalg.norm(l) ** 2
                             * torch.linalg.norm(c))), "")
        complex_path(f"hegst itype 1 n={ng} nb={nbg}",
                     lambda: (st.hegst(1, M(ha, st.HermitianMatrix, nb=nbg),
                                       L), 0), c64, ng, hegst_check,
                     "hegst")
        del ga, gb, ha, hbm, L, l
        g2 = crandn(gen, N, N, dtype=c128)
        am = 0.01 * g2 + N ** 0.5 * torch.eye(N, device="cuda", dtype=c128)
        b2 = crandn(gen, N, NRHS, dtype=c128)
        for name, mat, cls in (("gesv_mixed", am, st.Matrix),
                               ("posv_mixed", (g2 + g2.mH) / 2
                                + 4 * N ** 0.5 * torch.eye(
                                    N, device="cuda", dtype=c128),
                                st.HermitianMatrix)):
            Am, Bm = M(mat, cls), M(b2)

            def run_mixed_c(fn=getattr(st, name), Am=Am, Bm=Bm):
                X, iters, info = fn(Am, Bm)
                say(f"    {name} complex128: iters {iters}, fallback "
                    f"{mixed.used_fallback()}")
                assert not mixed.used_fallback() and iters < IR_ITERMAX
                return X, info
            complex_path(name, run_mixed_c, c128, N,
                         lambda X, mat=mat: (cresidual(mat, X.to_dense(),
                                                       b2), ""))
            del Am, mat
        del g2, am, b2
        ns = SHIM_C_N
        gs = crandn(gen, ns, ns)
        bs = crandn(gen, ns, NRHS)
        an, bn = gs.cpu().numpy(), bs.cpu().numpy()

        def shim(label, dtype, call, a_, b_, key=None):
            def fn():
                out = call()
                return out[0], out[1] if isinstance(out, tuple) else 0
            complex_path(label, fn, dtype, ns,
                         lambda x: (cresidual(a_, torch.from_numpy(x).cuda(),
                                              b_), ""), key)
        shim("slate_cgesv", c64, lambda: la.slate_cgesv(an, bn), gs, bs,
             "slate_cgesv")
        sp = ((gs + gs.mH) / 2).to(c128) + 4 * ns ** 0.5 * torch.eye(
            ns, device="cuda", dtype=c128)
        shim("slate_zposv", c128,
             lambda: la.slate_zposv("L", sp.cpu().numpy(),
                                    bs.to(c128).cpu().numpy()),
             sp, bs.to(c128))
        del sp
        at = gs[:, :ns // 2].contiguous()
        x0 = crandn(gen, ns // 2, NRHS)
        bt = (at.to(c128) @ x0.to(c128)).to(c64)
        shim(f"slate_cgels {ns}x{ns // 2} (B = A·X0)", c64,
             lambda: (la.slate_cgels(at.cpu().numpy(), bt.cpu().numpy()), 0),
             at, bt, "slate_cgels")
        ref = gs.to(c128) @ gs.mH.to(c128)
        base, t0 = start_path()
        cm = la.slate_cgemm("n", "c", 1.0, an, an, 0.0,
                            np.zeros((ns, ns), np.complex64))
        ms, _, _ = end_path(base, t0, {})
        err = crel_err(torch.from_numpy(cm).cuda(), ref)
        tight = 16 * ns ** 0.5 * 2.0 ** -24
        say(f"  slate_cgemm n, c at {ns}: ms {ms:.3f}, rel_err {err:.3e} "
            f"(bound 16*sqrt(k)*2^-24 = {tight:.3e})")
        assert err <= tight, err


def phase_generator():
    """2h: every kind of ``generate_matrix`` at 4096/256 (the structured
    kinds, whose cost is host numpy QR, at 2048) on the card and on the
    CPU: the uniform and binary random kinds and the structured kinds bit
    for bit equal, randn and the formula kinds within 8·2⁻²⁴ of the
    largest entry; ``randn`` at 16384/1024 timed beside ``torch.randn``
    on the card and the bytes it writes."""
    import slate_tpu_torch as st
    from slate_tpu_torch.utils import generator as gen_mod
    cards = st.Grid(1, 1)
    cpu = st.Grid(1, 1, device="cpu")
    exact = ("rand", "randu", "rands", "randb", "randr", "svd", "heev",
             "poev", "spd")
    kinds = gen_mod.FORMULA_KINDS + gen_mod._RANDOM_KINDS + \
        gen_mod._STRUCTURED_KINDS
    worst = {}
    for kind in kinds:
        n = GEN_STRUCT_N if kind in gen_mod._STRUCTURED_KINDS else GEN_N
        on = {}
        for g in (cards, cpu):
            A = st.generate_matrix(kind, n, nb=GEN_NB, grid=g, seed=5,
                                   dist="geo")
            on[g.device.type] = A.to_dense().cpu()
        x, y = on["cuda"], on["cpu"]
        assert bool(torch.isfinite(x).all()), kind
        if kind in exact:
            assert torch.equal(x, y), kind
            worst[kind] = 0.0
        else:
            d = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
            worst[kind] = d
            assert d <= GEN_TOL, (kind, d)
    say(f"generator {GEN_N}/{GEN_NB} (structured {GEN_STRUCT_N}) card vs CPU"
        f": bitwise {list(exact)}; max |card - CPU|/max|CPU| "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()
                    if k not in exact)
        + f" (bound 8*2^-24 = {GEN_TOL:.3e})")

    def draw():
        st.generate_matrix("randn", N, nb=NB, grid=cards, seed=5)
    ms = time_ms(draw, reps=3)
    lib = time_ms(lambda: torch.randn(N, N, device="cuda"), reps=3)
    bms = bound(0.0, 4.0 * N * N)[0]
    say(f"  randn {N}/{NB} on the card: ms {ms:.3f}, torch.randn ms "
        f"{lib:.3f}, bound_ms {bms:.4f} (bytes)")


def phase_complex_failure_report():
    """4i: card = CPU for complex: a non-HPD complex64 potrf's info, a
    singular complex64 gesv's info; unmqr with Op.Trans on complex
    raises on both; slate_cheev and slate_cgesvd give the CPU's λ and σ
    within 10·n·2⁻²⁴ of the largest."""
    import slate_tpu_torch as st
    from slate_tpu_torch import lapack_api as la
    rng = np.random.default_rng(92)
    n, nb = 512, 128
    g = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    hpd = (g + g.conj().T) / 2 + 4 * n ** 0.5 * np.eye(n, dtype=np.float32)
    hpd[300, 300] = -1000.0
    b = (rng.standard_normal((n, 2))
         + 1j * rng.standard_normal((n, 2))).astype(np.complex64)
    sing = g.copy()
    sing[:, 100] = 0.0
    out = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        _, pinfo = st.potrf(st.HermitianMatrix.from_dense(hpd, nb=nb,
                                                          grid=grid))
        _, _, piv, ginfo = st.gesv(st.Matrix.from_dense(sing, nb=nb,
                                                        grid=grid),
                                   st.Matrix.from_dense(b, nb=nb, grid=grid))
        QR, T = st.geqrf(st.Matrix.from_dense(g, nb=nb, grid=grid))
        try:
            st.unmqr(st.Side.Left, st.Op.Trans, QR, T,
                     st.Matrix.from_dense(b, nb=nb, grid=grid))
            raised = False
        except st.SlateError as e:
            raised = "ConjTrans" in str(e)
        out[dev] = (int(pinfo), int(ginfo), raised, piv.cpu())
    shims = []
    for name, args in (("slate_cheev", ("N", "L", hpd)),
                       ("slate_cgesvd", ("N", "N", g))):
        w = {dev: getattr(la, name)(*args, grid=st.Grid(1, 1, device=dev))[0]
             for dev in ("cuda", "cpu")}
        shims.append(float(np.abs(w["cuda"] - w["cpu"]).max()
                           / np.abs(w["cpu"]).max()))
        assert w["cuda"].dtype == w["cpu"].dtype == np.float32, name
    same_piv = torch.equal(out["cuda"][3], out["cpu"][3])
    say(f"complex failure report n={n} nb={nb}: non-HPD potrf info card "
        f"{out['cuda'][0]}, CPU {out['cpu'][0]}; singular gesv info card "
        f"{out['cuda'][1]}, CPU {out['cpu'][1]} (pivots equal {same_piv}); "
        f"unmqr Op.Trans raises card {out['cuda'][2]}, CPU {out['cpu'][2]}; "
        f"slate_cheev, slate_cgesvd card vs CPU max|d|/max "
        f"{shims[0]:.3e}, {shims[1]:.3e} (bound {10 * n * 2.0 ** -24:.3e})")
    assert out["cuda"][:3] == out["cpu"][:3] == (3, 1, True)
    assert max(shims) <= 10 * n * 2.0 ** -24, shims


def phase_complex_utils():
    """2h, 3t and 4i."""
    timed("2h generator", phase_generator)
    timed("3t complex solvers", phase_complex_solvers)
    timed("4i complex failure report", phase_complex_failure_report)


# ---------------------------------------------------------------------------
# the complex and float64 two-stage slice
# ---------------------------------------------------------------------------

# 2i: K8/K9 in the new types, held to their plain versions at these
# shapes, a band of None being the one preferred_eig_band gives the main
# paths (64); 128 is past the shared memory of the 8- and 16-byte types
# (the plain chases' host loops set 2i's time: (1024, 64) and (600, 32)
# were cut to (512, 64) and (300, 32) to keep the script within its
# limit; the card tests hold (600, 32) to the plain version)
CHASE_TYPE_SHAPES = ((512, None), (300, 32), (512, 128))
# ... then at (CHASE_TYPED_CHECK_N, the main paths' band) without the
# plain version (spectrum, rebuilt band, bits), and timed at (n, that
# band) and at CHASE_WIDE_BAND; the checks ran at the timed n until the
# script neared its limit (their dense f64 and complex128 spectra and
# rebuilt bands grow as n³)
CHASE_TYPED_CHECK_N = 2048
CHASE_TIME_N = {torch.float64: EIG_N, torch.complex64: EIG_N,
                torch.complex128: 4096}
CHASE_WIDE_BAND = 128


def chase_work_typed(n, b, which, dtype):
    """(flops, bytes, peak) of one chase in ``dtype``: :func:`chase_work`'s
    real counts, a complex multiply-add four real ones, each element
    ``itemsize`` bytes, against the FP32 or FP64 peak."""
    flops, nbytes = chase_work(n, b, which)
    item = torch.empty((), dtype=dtype).element_size()
    real = dtype.to_real() if dtype.is_complex else dtype
    peak = FP32_PEAK if real == torch.float32 else FP64_PEAK
    return (flops * (4 if dtype.is_complex else 1), nbytes * item / 4, peak)


def phase_chase_types():
    """2i: K8 and K9 in float64, complex64 and complex128 against their
    plain versions on the card at bands 64, 32 and 128; then at
    (2048, 64) held to the dense band's spectrum, the band rebuilt from
    the reflectors and their own bits without the plain version, and
    timed at (8192, 64) (complex128 at 4096), the main paths' shape, and
    at band 128, with the bound for its type."""
    from slate_tpu_torch.internal import _build
    from slate_tpu_torch.internal import kernels as K
    from slate_tpu_torch.internal.band_wave import preferred_eig_band
    gen = torch.Generator(device="cuda").manual_seed(120)
    say("bulge-chase kernels in float64, complex64, complex128 (on the card):")
    for name, log in sorted(_build.BUILD_LOG.items()):
        if name in ("hb2st_chase", "band_chase"):
            for line in log.splitlines():
                if "Compiling entry" in line or "spill" in line:
                    say(f"  ptxas[{name}]: {line.strip()}")
    main = {dt: preferred_eig_band(n, dt, "cuda")
            for dt, n in CHASE_TIME_N.items()}
    for dtype in CHASE_TIME_N:
        for which in ("hb2st", "tb2bd"):
            for n, b in CHASE_TYPE_SHAPES:
                check_chase(which, n, b or main[dtype], gen, dtype)
            check_chase(which, CHASE_TYPED_CHECK_N, main[dtype], gen, dtype,
                        with_plain=False)
    times = {}
    for dtype, n in CHASE_TIME_N.items():
        for which, fn in (("hb2st", K.hb2st_chase), ("tb2bd", K.tb2bd_chase)):
            for b in (CHASE_WIDE_BAND, main[dtype]):
                ab = torch.randn(b + 1, n, generator=gen, device="cuda",
                                 dtype=dtype)
                ms = time_ms(lambda: fn(ab), reps=3)
                flops, nbytes, peak = chase_work_typed(n, b, which, dtype)
                bms, by = bound(flops, nbytes, peak)
                times[str(dtype)[6:], which, b] = ms
                say(f"  {which} {str(dtype)[6:]} kernel_ms {ms:.4f} at n={n} "
                    f"band={b}; bound_ms {bms:.4f} ({by}; "
                    f"{flops / 1e9:.2f} GFLOP, {nbytes / 2 ** 20:.1f} MiB); "
                    f"library_ms null")
                del ab
    return times


TWO_STAGE_VEC_N, TWO_STAGE_VEC_NB = 4096, 512   # 3u: 3i's shape
TWO_STAGE_SVD_M, TWO_STAGE_SVD_N = 6144, 4096   # 3u: 3k's shape
TWO_STAGE_VEC_C128_N = 2048    # 3u: complex128 heev with vectors
SHIM_EIG_N = 4096              # 3u: the c/z heev and gesvd shims
# 3u: the complex64 and float64 values paths (heev, gesvd); they ran at
# EIG_N until the script neared its limit: their host stages (sterf,
# bdsqr) and the f64 references grow as n² to n³
TWO_STAGE_VALS_N = 4096


def herm_card(n, seed, dtype=torch.complex64):
    """(G + Gᴴ)/2 on the card, G Gaussian (complex: O(1) parts)."""
    g = torch.randn(n, n, generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda", dtype=dtype)
    return (g + g.mH) / 2


def two_stage_path(label, fn, check, dtype, n, counts, key=None,
                   tight=None):
    """One path of 3u: the launch counts set to 0 just before ``fn(times)``
    and exactly ``counts`` just after; its time (one run) and stage split;
    ``check(out)``'s reading within 10·n·u (and within ``tight`` when
    given). A complex64 path with a ``key`` runs again with the FP32 pins removed, and
    :func:`hold_second_bound` holds both readings to TF32_TIGHT[key].
    Returns the launch counts and ``out``."""
    base, t0 = start_path()
    times = {}
    out = fn(times)
    ms, launches, peak_gib = end_path(base, t0, counts)
    res, text = check(out)
    limit = 10 * n * unit_roundoff(dtype)
    split = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
    say(f"  {label} {str(dtype)[6:]}: ms {ms:.3f}"
        + (" (stage clock on)" if split else "") + f", {text} "
        f"(bound 10*n*u = {limit:.3e}), peak device memory above its "
        f"inputs {peak_gib:.3f} GiB" + (f"; stage split ms: {split}"
                                         if split else ""))
    assert res <= limit, (label, res, limit)
    assert tight is None or res <= tight, (label, res, tight)
    if key is not None:
        with fp32_pins_removed():
            control = fn(None)
        hold_second_bound(key, res, check(control)[0])
    return launches, out


def eig_values_check(ref, rdt, n):
    """max|λ − λ_ref|/‖A‖₂ of ``(lam, Z)``, λ of the real dtype."""
    norm2 = float(ref.abs().max())

    def check(out):
        lam = out[0]
        assert lam.dtype == rdt and tuple(lam.shape) == (n,)
        assert bool(torch.isfinite(lam).all())
        err = float((lam.double() - ref).abs().max()) / norm2
        return err, f"max|lam - lam_ref|/|A|_2 {err:.3e}"
    return check


def eig_vectors_check(a, rdt, n):
    """max(‖A·Z − Z·Λ‖_F/‖A‖_F, ‖ZᴴZ − I‖_F/n) in complex128/f64."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    a64 = a.to(wide)

    def check(out):
        lam, Z = out
        assert lam.dtype == rdt
        z = Z.to_dense().to(wide)
        res = float(torch.linalg.norm(a64 @ z - z * lam.double())
                    / torch.linalg.norm(a64))
        orth = float(torch.linalg.norm(
            z.mH @ z - torch.eye(n, device="cuda", dtype=wide)) / n)
        return max(res, orth), (f"|AZ - Z Lambda|/|A| {res:.3e}, "
                                f"|Z^H Z - I|/n {orth:.3e}")
    return check


def sv_values_check(ref, rdt, n):
    """max|σ − σ_ref|/σ_max of ``(s, U, VT)``, σ of the real dtype."""
    smax = float(ref.max())

    def check(out):
        s = out[0]
        assert s.dtype == rdt and tuple(s.shape) == (n,)
        assert bool(torch.isfinite(s).all())
        err = float((s.double() - ref).abs().max()) / smax
        return err, f"max|s - s_ref|/s_max {err:.3e}"
    return check


def phase_two_stage_types():
    """3u: the two-stage paths in complex64 (unless marked) on the card,
    with the caller's TF32 on: heev values at 4096/128 and with vectors
    (DC) at 4096/512, gesvd values at 4096² and with U, Vᴴ at 6144×4096,
    hegv itype 1–3 at 4096/512; float64 heev and gesvd values at 4096 by
    TwoStage (the repair: they raised on the card);
    complex128 heev with vectors at 2048; slate_cheev, slate_zheev,
    slate_cgesvd, slate_zgesvd at 4096 on their default grid (Auto: the
    library's dense eigensolver and SVD, no kernel). Each complex64
    two-stage path also meets TF32_TIGHT[key] and runs again with the
    FP32 pins removed as the control."""
    import slate_tpu_torch as st
    from slate_tpu_torch import lapack_api as la
    from slate_tpu_torch.internal.precision import tf32_matmul
    grid = st.Grid(1, 1)
    c64, c128, f64 = torch.complex64, torch.complex128, torch.float64
    eo = {st.Option.MethodEig: st.MethodEig.TwoStage}
    so = {st.Option.MethodSVD: st.MethodSVD.TwoStage}
    dc = {st.Option.MethodEig: st.MethodEig.DC}
    counts = {}
    H = lambda t, nb: st.HermitianMatrix.from_dense(t, nb=nb, grid=grid)
    G = lambda t, nb: st.Matrix.from_dense(t, nb=nb, grid=grid)
    say("two-stage paths in complex64 (unless given) and float64 on "
        "Grid(1,1), the caller's TF32 on:")
    with tf32_matmul():
        st.heev(H(herm_card(512, 1), EIG_NB), eo, want_vectors=False)
        st.svd_vals(G(herm_card(512, 2), EIG_NB), so)     # warm-up
        n = TWO_STAGE_VALS_N
        a = herm_card(n, 130)
        A = H(a, EIG_NB)
        ref = torch.linalg.eigvalsh(a.to(c128))
        counts["heev_vals_c64"], _ = two_stage_path(
            f"heev values n={n} nb={EIG_NB} TwoStage",
            lambda t: st.heev(A, eo, False, t),
            eig_values_check(ref, torch.float32, n), c64, n,
            {"hb2st_vmem": 1}, "heev_vals")
        phase_breakdown("complex64 heev (values)",
                        lambda: st.heev(A, eo, False), cpu=False)
        del A, ref
        g = crandn(torch.Generator(device="cuda").manual_seed(131), n, n)
        Ag = G(g, EIG_NB)
        ref = spectrum(g.to(c128), upper=True).flip(0)
        counts["gesvd_vals_c64"], _ = two_stage_path(
            f"gesvd values {n}x{n} nb={EIG_NB} TwoStage",
            lambda t: st.gesvd(Ag, so, times=t),
            sv_values_check(ref, torch.float32, n), c64, n,
            {"tb2bd_vmem": 1}, "gesvd_vals")
        del Ag, g, ref
        n, nb = TWO_STAGE_VEC_N, TWO_STAGE_VEC_NB
        a = herm_card(n, 132)
        A = H(a, nb)
        counts["heev_c64"], _ = two_stage_path(
            f"heev vectors n={n} nb={nb} DC",
            lambda t: st.heev(A, dc, times=t),
            eig_vectors_check(a, torch.float32, n), c64, n,
            {"hb2st_vmem": 1}, "heev")
        del A
        m, n = TWO_STAGE_SVD_M, TWO_STAGE_SVD_N
        g = crandn(torch.Generator(device="cuda").manual_seed(133), m, n)
        Ag = G(g, EIG_NB)
        g64 = g.to(c128)

        def svd_check(out):
            s, U, VT = out
            assert s.dtype == torch.float32
            u, vt = U.to_dense().to(c128), VT.to_dense().to(c128)
            eye = torch.eye(n, device="cuda", dtype=c128)
            rec = float(torch.linalg.norm(g64 - (u * s.double()) @ vt)
                        / torch.linalg.norm(g64))
            ou = float(torch.linalg.norm(u.mH @ u - eye) / n)
            ov = float(torch.linalg.norm(vt @ vt.mH - eye) / n)
            return max(rec, ou, ov), (f"|A - U S V^H|/|A| {rec:.3e}, "
                                      f"|U^H U - I|/n {ou:.3e}, "
                                      f"|V^H V - I|/n {ov:.3e}")
        counts["gesvd_c64"], _ = two_stage_path(
            f"gesvd U, V^H {m}x{n} nb={EIG_NB} TwoStage",
            lambda t: st.gesvd(Ag, so, True, True, t), svd_check, c64, m,
            {"tb2bd_vmem": 1}, "gesvd")
        del Ag, g, g64
        counts.update(hegv_complex(grid, dc))
        # float64 by TwoStage: raised on the card before the kernels took it
        n = TWO_STAGE_VALS_N
        a = herm_card(n, 134, f64)
        ref = torch.linalg.eigvalsh(a)
        A = H(a, EIG_NB)
        counts["heev_vals_f64"], _ = two_stage_path(
            f"heev values n={n} nb={EIG_NB} TwoStage",
            lambda t: st.heev(A, eo, False, t),
            eig_values_check(ref, f64, n), f64, n, {"hb2st_vmem": 1})
        g = torch.randn(n, n, generator=torch.Generator(device="cuda")
                        .manual_seed(135), device="cuda", dtype=f64)
        t1 = time.perf_counter()
        # QR iteration: the default Jacobi driver reads ~3e4·u here
        ref = torch.linalg.svdvals(g, driver="gesvd")
        torch.cuda.synchronize()
        say(f"    svdvals f64 reference (driver gesvd) took "
            f"{time.perf_counter() - t1:.1f} s")
        Ag = G(g, EIG_NB)
        counts["gesvd_vals_f64"], _ = two_stage_path(
            f"gesvd values {n}x{n} nb={EIG_NB} TwoStage",
            lambda t: st.gesvd(Ag, so, times=t),
            sv_values_check(ref, f64, n), f64, n, {"tb2bd_vmem": 1})
        del A, Ag, a, g, ref
        n = TWO_STAGE_VEC_C128_N
        a = herm_card(n, 136, c128)
        A = H(a, 512)
        counts["heev_c128"], _ = two_stage_path(
            f"heev vectors n={n} nb=512 DC",
            lambda t: st.heev(A, dc, times=t),
            eig_vectors_check(a, f64, n), c128, n, {"hb2st_vmem": 1})
        del a
        n = SHIM_EIG_N
        for pre, dt in (("c", c64), ("z", c128)):
            a = herm_card(n, 137, dt)
            an = a.cpu().numpy()
            rdt = torch.float32 if dt == c64 else f64
            ref = torch.linalg.eigvalsh(a.to(c128))
            two_stage_path(
                f"slate_{pre}heev('N') n={n}",
                lambda t: (torch.from_numpy(getattr(la, f"slate_{pre}heev")(
                    "N", "L", an)[0]).to("cuda"), None),
                eig_values_check(ref, rdt, n), dt, n, {})
            # σ of a Hermitian matrix: its |λ|
            ref = ref.abs().sort(descending=True).values
            two_stage_path(
                f"slate_{pre}gesvd('N', 'N') {n}x{n}",
                lambda t: (torch.from_numpy(getattr(la, f"slate_{pre}gesvd")(
                    "N", "N", an)[0]).to("cuda"),),
                sv_values_check(ref, rdt, n), dt, n, {})
            del a, an, ref
    return counts


def hegv_complex(grid, opts):
    """3u (hegv): itype 1, 2, 3 at 3r's shape in complex64, A = (G + Gᴴ)/2,
    B = G₂·G₂ᴴ/n + I, held to 3r's bounds (10·n·2⁻²⁴·‖A‖₂·κ(B) and
    √n·2⁻²⁴·‖A‖₂·κ(B)) against a complex128 reference formed on the card,
    and to TF32_TIGHT with the pins removed as the control; the complex
    potrf, hegst and solves are library ops, so K8 alone launches."""
    import slate_tpu_torch as st
    c128 = torch.complex128
    n, nb = HEGV_N, HEGV_NB
    a = herm_card(n, 138)
    gb = crandn(torch.Generator(device="cuda").manual_seed(139), n, n)
    bm = (gb.to(c128) @ gb.mH.to(c128) / n).to(torch.complex64) \
        + torch.eye(n, device="cuda")
    del gb
    A = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid)
    Bh = st.HermitianMatrix.from_dense(bm, nb=nb, grid=grid)
    a64, b64 = a.to(c128), bm.to(c128)
    l64 = torch.linalg.cholesky(b64)
    ev_b = torch.linalg.eigvalsh(b64)
    norm_a = float(torch.linalg.eigvalsh(a64).abs().max())
    kappa = float(ev_b[-1] / ev_b[0])
    scale = norm_a * kappa
    tight = n ** 0.5 * 2.0 ** -24 * scale
    say(f"  hegv complex64 n={n} nb={nb} DC: |A|_2 {norm_a:.3f}, kappa(B) "
        f"{kappa:.3f}; 3r's bounds over |A|_2*kappa(B): 10*n*2^-24 and "
        f"sqrt(n)*2^-24 = {tight / scale:.3e}")
    counts = {}
    for itype in (1, 2, 3):
        if itype == 1:
            y = torch.linalg.solve_triangular(l64, a64, upper=False)
            cc = torch.linalg.solve_triangular(l64, y.mH, upper=False)
        else:
            cc = l64.mH @ a64 @ l64
        ref = torch.linalg.eigvalsh(cc)

        def check(out, itype=itype, ref=ref):
            lam, Z, info = out
            assert int(info) == 0 and lam.dtype == torch.float32
            z = Z.to_dense().to(c128)
            lam64 = lam.double()
            err = float((lam64 - ref).abs().max())
            if itype == 1:
                r = a64 @ z - (b64 @ z) * lam64
            else:
                r = (a64 @ (b64 @ z) if itype == 2 else b64 @ (a64 @ z)) \
                    - z * lam64
            res = float(torch.linalg.norm(r) / torch.linalg.norm(z))
            worst = max(err, res) / scale
            return worst, (f"itype {itype}: max|lam - lam_ref| {err:.3e}, "
                           f"|R|_F/|Z|_F {res:.3e}, over |A|_2*kappa(B) "
                           f"{worst:.3e}")
        counts[f"hegv{itype}_c64"], _ = two_stage_path(
            f"hegv itype {itype} n={n} nb={nb} DC",
            lambda t, itype=itype: st.hegv(itype, A, Bh, opts),
            check, torch.complex64, n, {"hb2st_vmem": 1}, f"hegv{itype}",
            tight / scale)
    return counts


def phase_complex_two_stage():
    """2i and 3u; their launch counts by path."""
    timed("2i bulge-chase kernels in float64, complex64, complex128",
          phase_chase_types)
    return timed("3u two-stage paths in complex and float64",
                 phase_two_stage_types)


# ---------------------------------------------------------------------------
# 3v: p×q grids of virtual ranks on the one card
# ---------------------------------------------------------------------------

PQ_LU_NB = 256       # gesv on 2×4: the nb that K10 (panel_plu_swap) admits
PQ_SMALL_N, PQ_SMALL_NB = 512, 128   # card against CPU, failure reports


def pq_counts(kind, n, nb):
    """The launches of one p×q solve with its right-hand sides in one
    tile column, from the code: ``posv`` K1 once a step (the diagonal
    tile factored once for every rank), K2 once a step but the last (the
    owner column's panel as one solve), K3 once a step in the forward
    solve; ``gesv`` K10 once a step (the gathered panel factored once),
    K3 once a step but the last (block row k's U tiles of every rank in
    one launch) and once a step in the forward solve; ``gesv_nopiv`` K7
    once a step and K3 as ``gesv``."""
    nt = n // nb
    if kind == "posv":
        return {"potrf_tile": nt, "trsm_right_lower_t": nt - 1,
                "trsm_left_lower": nt}
    if kind == "gesv":
        return {"panel_plu_pallas": nt, "trsm_left_lower": 2 * nt - 1}
    return {"lu_nopiv_tile": nt, "trsm_left_lower": 2 * nt - 1}


def pq_call(kind, p, q, a, b, nb, depth=0):
    """The solve ``kind`` of a, b on Grid(p, q) as a thunk."""
    import slate_tpu_torch as st
    grid = st.Grid(p, q)
    cls = st.HermitianMatrix if kind == "posv" else st.Matrix
    A = cls.from_dense(a, nb=nb, grid=grid)
    B = st.Matrix.from_dense(b, nb=nb, grid=grid)
    fn = {"posv": st.posv, "gesv": st.gesv, "gesv_nopiv": st.gesv_nopiv}[kind]
    return lambda: fn(A, B, {st.Option.PipelineDepth: depth})


def wall_ms(fn) -> float:
    """Wall time of one call after a warm-up (the p×q drivers wait for
    the host between steps, so their time is the wall's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def pq_checks(kind, a, b, out, label):
    """info 0, the residual and, for the LUs, ‖P·A − L·U‖ (and max|L|)."""
    if kind == "gesv":
        X, LU, piv, info = out
        assert int(info) == 0, (label, int(info))
        check_lu(a, LU, piv, X, b, label)
        return
    n = a.shape[0]
    limit = 10 * n * 2.0 ** -24
    X, F, info = out
    assert int(info) == 0, (label, int(info))
    x = X.to_dense()
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
    msg = f"  {label}: residual {r:.3e} (bound {limit:.3e})"
    assert bool(torch.isfinite(x).all()) and r <= limit, msg
    if kind == "gesv_nopiv":
        lu = F.to_dense()
        l = torch.tril(lu, -1)
        l.diagonal().fill_(1.0)
        with _f32():
            f = float(torch.linalg.norm(a - l @ torch.triu(lu))
                      / (n * torch.linalg.norm(a)))
        msg += f", |A-LU|/(n|A|) {f:.3e} (bound 1e-5)"
        assert f <= 1e-5, msg
    say(msg)


def same_outputs(x, y) -> bool:
    """Two solves' outputs (matrices, pivots, info) equal bit for bit."""
    for u, v in zip(x, y):
        u, v = getattr(u, "data", u), getattr(v, "data", v)
        ok = (same_bits(u, v) if u.dtype == torch.float32
              else torch.equal(u, v))
        if not ok:
            return False
    return True


def phase_pq_kernels():
    """3v (kernels): K2, K3 and K10 against their plain versions at the
    shapes that only the p×q paths give them."""
    from slate_tpu_torch.internal import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(90)
    l = lower_factor(NB, gen)
    b = torch.randn(N, NB, generator=gen, device="cuda")
    check("trsm_right_lower_t", lambda: K.trsm_right_lower_t(l, b),
          lambda: K.trsm_right_lower_t_plain(l, b),
          f"B=[{N},{NB}] (a p×q panel of every rank row)")
    for nb in (PQ_LU_NB, NB):
        lu = lower_factor(nb, gen, unit=True)
        t = torch.randn(nb, N, generator=gen, device="cuda")
        check("trsm_left_lower", lambda: K.trsm_left_lower(lu, t, True),
              lambda: K.trsm_left_lower_plain(lu, t, True),
              f"B=[{nb},{N}] unit (a block row of U tiles, step 0)")
    check_swap(f"[{N},{PQ_LU_NB}] (p×q gesv's first panel)",
               torch.randn(N, PQ_LU_NB, generator=gen, device="cuda"),
               bitwise=True)


def phase_pq():
    """3v: posv on 2×2 and 2×4 (16384/1024), gesv on 2×4 (16384/256) and
    gesv_nopiv on 2×2 (16384/1024), each at depth 0 and 1 with exact
    launch counts, depth 0 = depth 1 bit for bit, times beside the same
    call on Grid(1, 1); the three p×q gemm methods; card = CPU at n = 512
    on 2×4, with failure reports. Returns the launches by path."""
    import slate_tpu_torch as st
    phase_pq_kernels()
    gen = torch.Generator(device="cuda").manual_seed(91)
    n = N
    g = torch.randn(n, n, generator=gen, device="cuda")
    with _f32():
        a_spd = g @ g.T / n + torch.eye(n, device="cuda")
    del g
    a_gen = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    counts = {}
    for kind, nb, grids in (("posv", NB, ((2, 2), (2, 4))),
                            ("gesv", PQ_LU_NB, ((2, 4),)),
                            ("gesv_nopiv", NB, ((2, 2),))):
        a = a_spd if kind == "posv" else a_gen
        if kind == "gesv_nopiv":
            a = a_gen + n * torch.eye(n, device="cuda")
        one_ms = wall_ms(pq_call(kind, 1, 1, a, b, nb))
        for p, q in grids:
            out, ms = {}, {}
            pq_call(kind, p, q, a, b, nb)()              # warm-up
            for depth in (0, 1):
                fn = pq_call(kind, p, q, a, b, nb, depth)
                base, t0 = start_path()
                out[depth] = fn()
                ms[depth], launches, peak = end_path(
                    base, t0, pq_counts(kind, n, nb))
            label = f"{kind} f32 n={n} nb={nb} nrhs={NRHS} Grid({p},{q})"
            say(f"{label}: depth0_ms {ms[0]:.3f}, depth1_ms {ms[1]:.3f}, "
                f"Grid(1,1)_ms {one_ms:.3f}, peak device memory above its "
                f"inputs {peak:.3f} GiB")
            for depth in (0, 1):
                pq_checks(kind, a, b, out[depth], f"{label} depth {depth}")
            bits = same_outputs(out[0], out[1])
            say(f"  depth 0 and depth 1 equal bit for bit (X, factors, "
                f"pivots, info): {bits}")
            assert bits, f"{label}: depth 1 differs from depth 0"
            counts[f"{kind}_{p}x{q}"] = launches
            del out
        if kind == "posv":
            phase_breakdown("posv Grid(2,2)", pq_call(kind, 2, 2, a, b, nb))
            phase_breakdown("posv Grid(1,1)", pq_call(kind, 1, 1, a, b, nb))
        elif kind == "gesv":
            # thousands of small ops: the device alone is traced
            phase_breakdown("gesv Grid(2,4) nb=256",
                            pq_call(kind, 2, 4, a, b, nb), cpu=False)
        del a
    del a_spd, a_gen
    phase_pq_gemm(gen)
    phase_pq_card_vs_cpu()
    return counts


def phase_pq_gemm(gen):
    """3v (gemm): SUMMA, Ring and GemmA on 2×4 at [16384²]·[16384, 1024]
    against the f64 product formed on the card, held to 3r's bounds,
    timed beside Grid(1, 1) and ``torch.matmul``."""
    import slate_tpu_torch as st
    n, k = N, NB
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, k, generator=gen, device="cuda")
    ref = a.double() @ b.double()
    say(f"gemm f32 [{n},{n}]x[{n},{k}] nb={NB}: error against the f64 "
        f"product formed on the card")
    for label, grid, method in (
            ("Grid(1,1)", st.Grid(1, 1), None),
            ("Grid(2,4) SUMMA", st.Grid(2, 4), st.MethodGemm.GemmC),
            ("Grid(2,4) Ring", st.Grid(2, 4), st.MethodGemm.Ring),
            ("Grid(2,4) GemmA", st.Grid(2, 4), st.MethodGemm.GemmA)):
        A = st.Matrix.from_dense(a, nb=NB, grid=grid)
        B = st.Matrix.from_dense(b, nb=NB, grid=grid)
        C = st.Matrix.zeros(n, k, NB, grid)
        opts = {} if method is None else {st.Option.MethodGemm: method}
        check_product(f"gemm {label}",
                      lambda: st.gemm(1.0, A, B, 0.0, C, opts), ref, n,
                      lambda: a @ b)
        del A, B, C
    del a, b, ref


def phase_pq_card_vs_cpu():
    """3v (card = CPU): gesv and potrf on 2×4 at n = 512, nb = 128 on the
    card and on the CPU (the kernels' plain versions): pivots and info
    equal, factors within 10·n·2⁻²⁴; a non-SPD potrf and a singular gesv
    give the same info on both."""
    import slate_tpu_torch as st
    n, nb = PQ_SMALL_N, PQ_SMALL_NB
    gen = torch.Generator(device="cpu").manual_seed(92)
    a = torch.randn(n, n, generator=gen)
    s = a @ a.T / n + torch.eye(n)
    b = torch.randn(n, NRHS, generator=gen)
    bad = s.clone()
    bad[300, 300] = -1.0
    sing = a.clone()
    sing[:, 400] = 0.0
    limit = 10 * n * 2.0 ** -24
    res = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(2, 4, device=dev)
        _, LU, piv, info = st.gesv(st.Matrix.from_dense(a, nb=nb, grid=grid),
                                   st.Matrix.from_dense(b, nb=nb, grid=grid))
        L, linfo = st.potrf(st.HermitianMatrix.from_dense(s, nb=nb,
                                                          grid=grid))
        _, binfo = st.potrf(st.HermitianMatrix.from_dense(bad, nb=nb,
                                                          grid=grid))
        _, _, _, sinfo = st.gesv(st.Matrix.from_dense(sing, nb=nb, grid=grid),
                                 st.Matrix.from_dense(b, nb=nb, grid=grid))
        res[dev] = (LU.to_dense().cpu(), piv.cpu(), int(info),
                    torch.tril(L.to_dense()).cpu(), int(linfo), int(binfo),
                    int(sinfo))
    c, h = res["cuda"], res["cpu"]
    e_lu, e_l = rel_err(c[0], h[0]), rel_err(c[3], h[3])
    piv_eq = torch.equal(c[1], h[1])
    say(f"card vs CPU on Grid(2,4) n={n} nb={nb}: gesv pivots equal "
        f"{piv_eq}, info {c[2]}/{h[2]}, LU rel_err {e_lu:.3e}; potrf L "
        f"rel_err {e_l:.3e} (bound {limit:.3e}); non-SPD potrf info "
        f"{c[5]}/{h[5]} (expected {300 // nb + 1}), singular gesv info "
        f"{c[6]}/{h[6]}")
    assert piv_eq and c[2] == h[2] == 0 and c[4] == h[4] == 0
    assert e_lu <= limit and e_l <= limit, (e_lu, e_l)
    assert c[5] == h[5] == 300 // nb + 1 and c[6] == h[6] >= 1, (c, h)


# ---------------------------------------------------------------------------
# 3w: p×q least squares and the two-stage eigensolver and SVD
# ---------------------------------------------------------------------------

F64_REFS = {}        # 3h's and 3j's f64 spectra, kept for 3w's same matrices


def pq_beside_one(label, make, fn, expect, grids):
    """``fn(make(grid))`` on Grid(1, 1) and on each p×q grid of
    ``grids``, each with the launch counts set to 0 just before it and
    read just after (``expect[(p, q)]`` exactly). Returns the outputs
    and the launches, each by grid; the times are those of each one
    call."""
    import slate_tpu_torch as st
    outs, ms, launches = {}, {}, {}
    for p, q in ((1, 1),) + tuple(grids):
        args = make(st.Grid(p, q))
        base, t0 = start_path()
        outs[(p, q)] = fn(*args)
        ms[(p, q)], launches[(p, q)], _ = end_path(base, t0, expect[(p, q)])
        del args
    say(f"  {label}: " + ", ".join(f"Grid({p},{q})_ms {v:.3f}"
                                   for (p, q), v in ms.items()))
    return outs, launches


def phase_pq_least_squares():
    """3w (least squares): geqrf and gels (Householder, CholQR) at
    16384×4096/1024 on 2×2 and 2×4, the LQ gels at 4096×16384 on 2×4."""
    import slate_tpu_torch as st
    m, n = QR_M, QR_N
    kt = n // NB
    gen = torch.Generator(device="cuda").manual_seed(93)
    a = torch.randn(m, n, generator=gen, device="cuda")
    x0 = torch.randn(n, NRHS, generator=gen, device="cuda")
    with _f32():
        b0 = a @ x0
    b = torch.randn(m, NRHS, generator=gen, device="cuda")
    grids = ((2, 2), (2, 4))
    counts = {}
    limit = 10 * m * 2.0 ** -24
    say(f"p×q least squares f32 m={m} n={n} nb={NB} nrhs={NRHS} (bounds "
        f"{limit:.3e} unless stated):")
    qr_counts = {(1, 1): {"qr_call": 32}, (2, 2): {}, (2, 4): {}}
    mat = lambda x, g: st.Matrix.from_dense(x, nb=NB, grid=g)  # noqa: E731
    outs, _ = pq_beside_one("geqrf", lambda g: (mat(a, g),), st.geqrf,
                            qr_counts, grids)
    for (p, q), (QR, T) in outs.items():
        g = QR.grid
        r = torch.triu(QR.to_dense()[:n])
        R0 = mat(torch.cat([r, r.new_zeros(m - n, n)]), g)
        qr_ = st.unmqr(st.Side.Left, st.Op.NoTrans, QR, T, R0).to_dense()
        I0 = mat(torch.eye(m, n, device="cuda"), g)
        q1 = st.unmqr(st.Side.Left, st.Op.NoTrans, QR, T, I0).to_dense()
        with _f32():
            rec = float(torch.linalg.norm(a - qr_) / torch.linalg.norm(a))
            orth = float(torch.linalg.norm(q1.T @ q1 - torch.eye(
                n, device="cuda")) / n)
        say(f"    geqrf Grid({p},{q}): |A-QR|/|A| {rec:.3e}, |Q1^T Q1 - "
            f"I|/n {orth:.3e}")
        assert T.shape == (kt, NB, NB) and bool(torch.isfinite(qr_).all())
        assert rec <= limit and orth <= limit, (p, q, rec, orth)
        del QR, T, R0, qr_, I0, q1
    del outs
    A24 = mat(a, st.Grid(2, 4))
    phase_breakdown("geqrf Grid(2,4)", lambda: st.geqrf(A24))
    del A24
    pq_t_cost(gen)
    qr_opts = {st.Option.MethodGels: st.MethodGels.Geqrf}
    for label, rhs, opts, expect in (
            ("gels Householder, consistent B", b0, qr_opts, qr_counts),
            ("gels Householder, Gaussian B", b, qr_opts, qr_counts),
            ("gels CholQR (the default at m >= 2n), Gaussian B", b, None,
             dict.fromkeys(((1, 1),) + grids,
                           {"potrf_tile": kt,
                            "trsm_right_lower_t": kt - 1}))):
        outs, launches = pq_beside_one(
            label, lambda g: (mat(a, g), mat(rhs, g), opts), st.gels,
            expect, grids)
        counts[f"{label.split(',')[0]} 2x4"] = launches[(2, 4)]
        for (p, q), X in outs.items():
            x = X.to_dense()
            assert bool(torch.isfinite(x).all()) and x.shape == (n, NRHS)
            if rhs is b0:
                err = rel_err(x, x0)
                say(f"    Grid({p},{q}): |X - X0|/|X0| {err:.3e} (bound "
                    f"1e-3)")
                assert err <= 1e-3, (label, p, q, err)
            else:
                res = normal_residual(a, x, b)
                say(f"    Grid({p},{q}): |A^T(AX-B)|/(|A|(|A||X|+|B|)) "
                    f"{res:.3e}")
                assert res <= limit, (label, p, q, res)
        del outs
    del a, b, b0
    at = torch.randn(n, m, generator=gen, device="cuda")      # m < n: LQ
    bt = torch.randn(n, NRHS, generator=gen, device="cuda")
    outs, launches = pq_beside_one(
        f"gels LQ (m={n}, n={m}), Gaussian B",
        lambda g: (mat(at, g), mat(bt, g)), st.gels,
        {(1, 1): {"qr_call": 32, "trsm_left_lower": kt},
         (2, 4): {"trsm_left_lower": kt}}, ((2, 4),))
    for (p, q), X in outs.items():
        x = X.to_dense()
        with _f32():
            res = float(torch.linalg.norm(at @ x - bt)
                        / (torch.linalg.norm(at) * torch.linalg.norm(x)
                           + torch.linalg.norm(bt)))
        say(f"    Grid({p},{q}): |AX-B|/(|A||X|+|B|) {res:.3e}")
        assert bool(torch.isfinite(x).all()) and res <= limit, (p, q, res)
    counts["gels LQ 2x4"] = launches[(2, 4)]
    return counts


def pq_t_cost(gen):
    """The T of one panel's reflectors on the card: the Gram-matrix
    recurrence of the p×q loops (``geqrf.panel_t``) beside the larft
    column recurrence of the JAX bodies (an nb-long loop of small
    launches), on a geqrf panel [16384, 1024] and a he2hb panel
    [8064, 128] (3w's heev at band 128), each within 10·nb·2⁻²⁴ of the
    f64 larft."""
    from slate_tpu_torch.internal.tile_kernels import extract_v, larft
    from slate_tpu_torch.linalg.geqrf import panel_t
    for h, w in ((QR_M, NB), (EIG_N - 128, 128)):
        pan, taus = torch.geqrf(torch.randn(h, w, generator=gen,
                                            device="cuda"))
        V = extract_v(pan, 0, h)
        t64 = larft(V.double(), taus.double())
        limit = 10 * w * 2.0 ** -24
        errs = [rel_err(f(V, taus), t64) for f in (panel_t, larft)]
        ms = [time_ms(lambda f=f: f(V, taus), reps=3)
              for f in (panel_t, larft)]
        say(f"  T of a [{h}, {w}] panel: Gram recurrence (panel_t) ms "
            f"{ms[0]:.3f}, rel_err {errs[0]:.3e}; larft ms {ms[1]:.3f}, "
            f"rel_err {errs[1]:.3e} (bound {limit:.3e}, against f64 larft)")
        assert max(errs) <= limit, (h, w, errs)


def phase_pq_eig():
    """3w (eig): heev values at 8192 (nb 1024, Auto) on 2×2, vectors (DC)
    and hegv itype 1 at 4096/512 on 2×2."""
    import slate_tpu_torch as st
    counts = {}
    n = EIG_N
    a = sym_matrix(n, 13)                                # 3h's matrix
    ref = F64_REFS.get("heev_vals")
    if ref is None:
        ref = torch.linalg.eigvalsh(a.double())
    norm2 = float(ref.abs().max())
    limit = 10 * n * 2.0 ** -24
    say(f"p×q eig f32: heev values n={n} nb={NB} Auto (Grid(1,1): the "
        f"dense route; 2x2: two-stage at the card's eig band):")
    outs, launches = pq_beside_one(
        "heev values",
        lambda g: (st.HermitianMatrix.from_dense(a, nb=NB, grid=g), None,
                   False),
        st.heev, {(1, 1): {}, (2, 2): {"hb2st_vmem": 1}}, ((2, 2),))
    counts["heev values 2x2"] = launches[(2, 2)]
    for (p, q), (lam, Z) in outs.items():
        err = float((lam.double() - ref).abs().max()) / norm2
        say(f"    Grid({p},{q}): max|lam - lam_ref|/|A|_2 {err:.3e} (bound "
            f"{limit:.3e})")
        assert Z is None and bool(torch.isfinite(lam).all()) and \
            err <= limit, (p, q, err)
    A22 = st.HermitianMatrix.from_dense(a, nb=NB, grid=st.Grid(2, 2))
    phase_breakdown("heev values Grid(2,2)",
                    lambda: st.heev(A22, None, False), cpu=False)
    del a, outs, A22
    n, nb = HEGV_N, HEGV_NB
    a = sym_matrix(n, 14)                                # 3i's matrix
    dc = {st.Option.MethodEig: st.MethodEig.DC}
    limit = 10 * n * 2.0 ** -24
    outs, launches = pq_beside_one(
        f"heev vectors n={n} nb={nb} DC",
        lambda g: (st.HermitianMatrix.from_dense(a, nb=nb, grid=g), dc),
        st.heev, dict.fromkeys(((1, 1), (2, 2)), {"hb2st_vmem": 1}),
        ((2, 2),))
    counts["heev vectors 2x2"] = launches[(2, 2)]
    eye = torch.eye(n, device="cuda")
    for (p, q), (lam, Z) in outs.items():
        z = Z.to_dense()
        with _f32():
            res = float(torch.linalg.norm(a @ z - z * lam)
                        / torch.linalg.norm(a))
            orth = float(torch.linalg.norm(z.T @ z - eye) / n)
        say(f"    Grid({p},{q}): |AZ - Z Lambda|/|A| {res:.3e}, |Z^T Z - "
            f"I|/n {orth:.3e} (bound {limit:.3e} each)")
        assert bool(torch.isfinite(z).all()) and res <= limit and \
            orth <= limit, (p, q, res, orth)
    del outs
    a = sym_matrix(n, 55)                                # 3r's hegv pair
    g2 = torch.randn(n, n, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(56))
    with _f32():
        bm = g2 @ g2.T / n + torch.eye(n, device="cuda")
    del g2
    a64, b64 = a.double(), bm.double()
    l64 = torch.linalg.cholesky(b64)
    y = torch.linalg.solve_triangular(l64, a64, upper=False)
    lam_ref = torch.linalg.eigvalsh(torch.linalg.solve_triangular(
        l64, y.T, upper=False))
    ev_b = torch.linalg.eigvalsh(b64)
    norm_a = float(torch.linalg.eigvalsh(a64).abs().max())
    kappa = float(ev_b[-1] / ev_b[0])
    bound = min(10 * n * 2.0 ** -24, n ** 0.5 * 2.0 ** -24) * norm_a * kappa
    nt = n // nb
    outs, launches = pq_beside_one(
        f"hegv itype 1 n={n} nb={nb} DC",
        lambda g: (1, st.HermitianMatrix.from_dense(a, nb=nb, grid=g),
                   st.HermitianMatrix.from_dense(bm, nb=nb, grid=g), dc),
        st.hegv,
        {(1, 1): {"potrf_tile": nt, "trsm_right_lower_t": nt - 1,
                  "trsm_left_lower": nt, "hb2st_vmem": 1},
         (2, 2): {"potrf_tile": nt, "trsm_right_lower_t": nt - 1,
                  "trsm_left_lower": 2 * nt, "hb2st_vmem": 1}}, ((2, 2),))
    counts["hegv itype 1 2x2"] = launches[(2, 2)]
    for (p, q), (lam, Z, info) in outs.items():
        z = Z.to_dense().double()
        err = float((lam.double() - lam_ref).abs().max())
        res = float(torch.linalg.norm(a64 @ z - (b64 @ z) * lam.double())
                    / torch.linalg.norm(z))
        say(f"    Grid({p},{q}): info {int(info)}, max|lam - lam_ref| "
            f"{err:.3e}, |R|_F/|Z|_F {res:.3e} (bound {bound:.3e})")
        assert int(info) == 0 and bool(torch.isfinite(z).all())
        assert max(err, res) <= bound, (p, q, err, res)
    return counts


def phase_pq_svd():
    """3w (svd): gesvd values at 8192² on 2×4, with U and Vᵀ at
    6144×4096 on 2×2 (nb 128, TwoStage)."""
    import slate_tpu_torch as st
    counts = {}
    n, nb = EIG_N, EIG_NB
    gen = torch.Generator(device="cuda").manual_seed(15)   # 3j's matrix
    a = torch.randn(n, n, generator=gen, device="cuda")
    ref = F64_REFS.get("gesvd_vals")
    if ref is None:
        ref = torch.linalg.svdvals(a.double())
    two = {st.Option.MethodSVD: st.MethodSVD.TwoStage}
    limit = 10 * n * 2.0 ** -24
    say(f"p×q svd f32 TwoStage: gesvd values {n}x{n} nb={nb}:")
    outs, launches = pq_beside_one(
        "gesvd values",
        lambda g: (st.Matrix.from_dense(a, nb=nb, grid=g), two), st.gesvd,
        dict.fromkeys(((1, 1), (2, 4)), {"tb2bd_vmem": 1}), ((2, 4),))
    counts["gesvd values 2x4"] = launches[(2, 4)]
    for (p, q), (s, _, _) in outs.items():
        err = float((s.double() - ref).abs().max()) / float(ref[0])
        say(f"    Grid({p},{q}): max|s - s_ref|/s_max {err:.3e} (bound "
            f"{limit:.3e})")
        assert bool(torch.isfinite(s).all()) and err <= limit, (p, q, err)
    del a, outs
    m, n = 6144, 4096
    gen = torch.Generator(device="cuda").manual_seed(16)   # 3k's matrix
    a = torch.randn(m, n, generator=gen, device="cuda")
    outs, launches = pq_beside_one(
        f"gesvd U, VT {m}x{n}",
        lambda g: (st.Matrix.from_dense(a, nb=nb, grid=g), two, True, True),
        st.gesvd, dict.fromkeys(((1, 1), (2, 2)), {"tb2bd_vmem": 1}),
        ((2, 2),))
    counts["gesvd vectors 2x2"] = launches[(2, 2)]
    limit = 10 * m * 2.0 ** -24
    eye = torch.eye(n, device="cuda")
    for (p, q), (s, U, VT) in outs.items():
        u, vt = U.to_dense(), VT.to_dense()
        with _f32():
            rec = float(torch.linalg.norm(a - (u * s) @ vt)
                        / torch.linalg.norm(a))
            ou = float(torch.linalg.norm(u.T @ u - eye) / n)
            ov = float(torch.linalg.norm(vt @ vt.T - eye) / n)
        say(f"    Grid({p},{q}): |A - U S VT|/|A| {rec:.3e}, |U^T U - I|/n "
            f"{ou:.3e}, |V^T V - I|/n {ov:.3e} (bound {limit:.3e} each)")
        assert u.shape == (m, n) and vt.shape == (n, n)
        assert max(rec, ou, ov) <= limit, (p, q, rec, ou, ov)
    return counts


def phase_pq_blas3():
    """3w (BLAS): hemm and symm (Lower) and trmm (Lower, non-unit) on both
    sides, her2k and syr2k, f32 at 16384/1024 on 2×4 beside Grid(1, 1)
    and ``torch.matmul``, held to 3r's bounds (``check_product``)."""
    import slate_tpu_torch as st
    n, nb, k = N, NB, NB
    gen = torch.Generator(device="cuda").manual_seed(94)
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, k, generator=gen, device="cuda")
    b2 = torch.randn(n, k, generator=gen, device="cuda")
    bt = b.T.contiguous()
    a64, b64, b2_64, bt64 = a.double(), b.double(), b2.double(), bt.double()
    low64 = a64.tril()
    full64 = low64 + low64.tril(-1).T
    full, t64 = full64.float(), low64
    t = t64.float()
    say(f"p×q Level-3 BLAS f32 n={n} nb={nb}, B [{n}, {k}] (Right: its "
        f"transpose); error against the f64 product formed on the card")
    for p, q in ((1, 1), (2, 4)):
        g = st.Grid(p, q)
        B, B2, Bt = (st.Matrix.from_dense(x, nb=nb, grid=g)
                     for x in (b, b2, bt))
        C, Ct = st.Matrix.zeros(n, k, nb, g), st.Matrix.zeros(k, n, nb, g)
        for cls, fn in ((st.HermitianMatrix, st.hemm),
                        (st.SymmetricMatrix, st.symm)):
            A = cls.from_dense(a, nb=nb, grid=g)
            check_product(f"{fn.__name__} Left Grid({p},{q})",
                          lambda: fn(st.Side.Left, 1.0, A, B, 0.0, C),
                          full64 @ b64, n, lambda: full @ b)
            check_product(f"{fn.__name__} Right Grid({p},{q})",
                          lambda: fn(st.Side.Right, 1.0, A, Bt, 0.0, Ct),
                          bt64 @ full64, n, lambda: bt @ full)
            del A
        T = st.TriangularMatrix.from_dense(a, nb=nb, grid=g)
        check_product(f"trmm Left Grid({p},{q})",
                      lambda: st.trmm(st.Side.Left, 1.0, T, B), t64 @ b64, n,
                      lambda: t @ b)
        check_product(f"trmm Right Grid({p},{q})",
                      lambda: st.trmm(st.Side.Right, 1.0, T, Bt),
                      bt64 @ t64, n, lambda: bt @ t)
        del T
        ref = b64 @ b2_64.T
        ref += b2_64 @ b64.T
        for cls, fn in ((st.HermitianMatrix, st.her2k),
                        (st.SymmetricMatrix, st.syr2k)):
            G = cls.zeros(n, n, nb, g)
            check_product(f"{fn.__name__} Grid({p},{q})",
                          lambda: fn(1.0, B, B2, 0.0, G), ref, k,
                          lambda: torch.addmm(b @ b2.T, b2, b.T))
            del G
        del ref, B, B2, Bt, C, Ct


def phase_pq_two_stage():
    """3w: p×q least squares and the two-stage eigensolver and SVD, each
    beside Grid(1, 1). Returns the launches by path."""
    counts = phase_pq_least_squares()
    counts.update(phase_pq_eig())
    counts.update(phase_pq_svd())
    phase_pq_blas3()
    return counts


# ---------------------------------------------------------------------------
# 3x: p×q inverses, condest, mixed solves and Aasen
# ---------------------------------------------------------------------------

PQ_CPLX_N = 8192     # 3x: the complex64 p×q cases


def pq_aasen_stage1_check(a, A, piv, n, nb):
    """‖P·A·Pᵀ − L·T·Lᵀ‖_F/‖A‖_F from stage 1 run again on A's grid
    (its L, T blocks and pivots), and whether its pivots repeat."""
    from slate_tpu_torch import runtime
    from slate_tpu_torch.linalg import hetrf as H
    L, Td, Ts, piv2, _ = H._stage1(A)
    ld = L.to_dense()[:n, :n]
    del L
    t = torch.block_diag(*Td)
    for k in range(n // nb - 1):
        t[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = Ts[k]
        t[k * nb:(k + 1) * nb, (k + 1) * nb:(k + 2) * nb] = Ts[k].mH
    perm = torch.from_numpy(runtime.resolve_pivots(piv.cpu().numpy(), n)
                            ).cuda()
    with _f32():
        f = float(torch.linalg.norm(a[perm][:, perm] - ld @ t @ ld.mH)
                  / torch.linalg.norm(a))
    return f, torch.equal(piv, piv2)


def phase_pq_aasen():
    """3x (Aasen): hesv f32 at 16384/256, nrhs 8 (3l's matrix) on 2×4
    beside Grid(1, 1), each with its exact launches (K10 once a live
    panel, K3 once a block row of hetrs's L solve), the stage split and
    hetrf alone; info 0, the residual and P·A·Pᵀ = L·T·Lᵀ within
    10·n·2⁻²⁴; the 2×4 call under ``torch.profiler``."""
    import slate_tpu_torch as st
    n, nb = N, AASEN_NB
    nt = n // nb
    a = sym_matrix(n, 19)
    gen = torch.Generator(device="cuda").manual_seed(20)
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    limit = 10 * n * 2.0 ** -24
    launches = {}
    for p, q in ((2, 4), (1, 1)):
        g = st.Grid(p, q)
        st.hesv(st.HermitianMatrix.from_dense(a[:2048, :2048], nb=nb,
                                              grid=g),
                st.Matrix.from_dense(b[:2048], nb=nb, grid=g))  # warm-up
        A = st.HermitianMatrix.from_dense(a, nb=nb, grid=g)
        B = st.Matrix.from_dense(b, nb=nb, grid=g)
        times = {}
        base, t0 = start_path()
        X, (L, FT, piv), info = st.hesv(A, B, times=times)
        ms, launches[(p, q)], peak = end_path(
            base, t0, {"panel_plu_pallas": nt - 1, "trsm_left_lower": nt})
        del L, FT
        t1 = time.perf_counter()
        st.hetrf(A)
        torch.cuda.synchronize()
        hetrf_ms = (time.perf_counter() - t1) * 1e3
        x = X.to_dense()
        with _f32():
            r = float(torch.linalg.norm(a @ x - b)
                      / (torch.linalg.norm(a) * torch.linalg.norm(x)))
        f, same = pq_aasen_stage1_check(a, A, piv, n, nb)
        split = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
        say(f"  hesv f32 n={n} nb={nb} nrhs={NRHS} Grid({p},{q}): info "
            f"{int(info)}, residual {r:.3e}, |PAP^T - LTL^T|/|A| {f:.3e} "
            f"(bound {limit:.3e} each), pivots repeat {same}; hetrf_ms "
            f"{hetrf_ms:.3f}, hesv_ms {ms:.3f} (split ms: {split}), peak "
            f"device memory above its inputs {peak:.3f} GiB")
        assert int(info) == 0 and bool(torch.isfinite(x).all())
        assert r <= limit and f <= limit and same, (p, q, r, f, same)
        if g.size > 1:
            # the device alone: 3l traces the host of the same loop
            phase_breakdown("hesv Grid(2,4)", lambda: st.hesv(A, B),
                            cpu=False)
        del A, B, X, x
    return {"hesv_2x4": launches[(2, 4)]}


def mixed_pq_case(label, solver, M, B, grid, chol, nb):
    """One mixed solve on ``grid`` (M and B re-tiled to ``nb`` and laid
    out there) with the launches set to 0 just before it and read just
    after, exactly: the p×q factorization's (``pq_counts``: K1 and K2 a
    step, or K10 a step and K3 a block row of U) and K3 once a step for
    each low-precision solve (its right-hand sides in one tile column),
    the solves counted by wrapping getrs and potrs; 3n's limits; its time
    beside the same call on Grid(1, 1) at the same nb (one run)."""
    import slate_tpu_torch as st
    from slate_tpu_torch.linalg import getrf as getrf_mod
    from slate_tpu_torch.linalg import mixed
    from slate_tpu_torch.linalg import potrf as potrf_mod
    M1, B1 = M.retile(nb), B.retile(nb)
    Mp, Bp = M1.redistribute(grid), B1.redistribute(grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver(M1, B1)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    calls = [0]
    real = getrf_mod.getrs, potrf_mod.potrs

    def counted(fn):
        def run(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return run

    getrf_mod.getrs, potrf_mod.potrs = (counted(f) for f in real)
    nt = N // nb
    try:
        base, t0 = start_path()
        X, iters, info = solver(Mp, Bp)
        torch.cuda.synchronize()
        expect = ({"potrf_tile": nt, "trsm_right_lower_t": nt - 1,
                   "trsm_left_lower": nt * calls[0]} if chol else
                  {"panel_plu_pallas": nt,
                   "trsm_left_lower": nt - 1 + nt * calls[0]})
        ms, launches, _ = end_path(base, t0, expect)
    finally:
        getrf_mod.getrs, potrf_mod.potrs = real
    fell_back = mixed.used_fallback()
    err = backward_error(Mp, X, Bp)
    limit = 10 * N * torch.finfo(B.dtype).eps / 2
    say(f"  {label} {str(B.dtype)[6:]} nrhs={B.n} nb={nb} Grid({grid.p},"
        f"{grid.q}): iters {iters}, info {int(info)}, fallback {fell_back}, "
        f"{calls[0]} solves, ms {ms:.3f} (Grid(1,1) ms {one_ms:.3f}), "
        f"backward error {err:.3e} (bound 10*n*eps/2 = {limit:.3e})")
    assert int(info) == 0 and not fell_back and iters < IR_ITERMAX, (
        label, int(info), fell_back, iters)
    assert X.grid == grid and bool(torch.isfinite(X.data).all())
    assert err <= limit, (label, err)
    return launches


def phase_pq_mixed():
    """3x (mixed): 3n's solves at n = 16384 on p×q grids: posv_mixed f32
    and f64 (nrhs 8) and posv_mixed_gmres f64 (nrhs 1) on 2×2 at nb 1024;
    gesv_mixed f32 (nrhs 8) and gesv_mixed_gmres f64 (nrhs 1) on 2×4 at
    nb 256, the p×q LU's nb."""
    import slate_tpu_torch as st
    A, S = mixed_matrices()
    gen = torch.Generator(device="cuda").manual_seed(45)

    def rhs(k, dt):
        return st.Matrix.from_dense(torch.randn(N, k, generator=gen,
                                                device="cuda").to(dt),
                                    nb=NB, grid=A.grid)

    f64 = torch.float64
    B8, B1 = rhs(NRHS, torch.float32), rhs(1, f64)
    g22, g24 = st.Grid(2, 2), st.Grid(2, 4)
    say(f"p×q mixed solves n={N} (3n's A and S):")
    counts = {}
    counts["posv_mixed_2x2"] = mixed_pq_case(
        "posv_mixed", st.posv_mixed, S, B8, g22, True, NB)
    counts["gesv_mixed_2x4"] = mixed_pq_case(
        "gesv_mixed", st.gesv_mixed, A, B8, g24, False, PQ_LU_NB)
    A64, S64 = A.astype(f64), S.astype(f64)
    del A, S
    mixed_pq_case("posv_mixed", st.posv_mixed, S64, B8.astype(f64), g22,
                  True, NB)
    mixed_pq_case("posv_mixed_gmres", st.posv_mixed_gmres, S64, B1, g22,
                  True, NB)
    mixed_pq_case("gesv_mixed_gmres", st.gesv_mixed_gmres, A64, B1, g24,
                  False, PQ_LU_NB)
    return counts


def phase_pq_inverses_health():
    """3x (inverses, health): getri and potri at 16384/1024 on 2×2 (3p's
    ratio; getri launches nothing, its solves being upper and right-side,
    potri's trtri K3 once a step in each grid column), each beside
    Grid(1, 1); potrf and getrf with ``health=True`` on 2×2, growth
    against 3o's true rcond, K3 16 for each condest solve."""
    import slate_tpu_torch as st
    from slate_tpu_torch.linalg import getrf as getrf_mod
    from slate_tpu_torch.linalg import potrf as potrf_mod
    A1, S1 = mixed_matrices()
    g = st.Grid(2, 2)
    A, S = A1.redistribute(g), S1.redistribute(g)
    nt = N // NB
    counts = {}
    for label in ("getri", "potri"):
        if label == "getri":
            F1, F = st.getrf(A1)[:2], st.getrf(A)[:2]
            fn, M, expect = st.getri, A1, {}
        else:
            F1, F = st.potrf(S1)[:1], st.potrf(S)[:1]
            fn, M, expect = st.potri, S1, {"trsm_left_lower": 2 * nt}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*F1)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        base, t0 = start_path()
        X = fn(*F)
        ms, counts[f"{label}_2x2"], _ = end_path(base, t0, expect)
        ratio = inverse_ratio(M.to_dense(), X.to_dense())
        say(f"  {label} n={N} nb={NB} Grid(2,2): ms {ms:.3f} (Grid(1,1) ms "
            f"{one_ms:.3f}), ratio |I - A*X|_1/(n*|A|_1*|X|_1*eps) "
            f"{ratio:.3e} (bound 30)")
        assert X.grid == g and ratio <= 30, (label, ratio)
        del X, F, F1
    for label, fn, mod, name, expect in (
            ("potrf", lambda: st.potrf(S, health=True), potrf_mod, "potrs",
             {"potrf_tile": nt, "trsm_right_lower_t": nt - 1}),
            ("getrf", lambda: st.getrf(A, health=True), getrf_mod, "getrs",
             {"trsm_left_lower": nt - 1})):
        calls = [0]
        real = getattr(mod, name)

        def run(*a, real=real, **kw):
            calls[0] += 1
            return real(*a, **kw)

        setattr(mod, name, run)
        try:
            base, t0 = start_path()
            rep = fn()[-1]
            torch.cuda.synchronize()
            want = dict(expect)
            want["trsm_left_lower"] = want.get("trsm_left_lower", 0) + \
                nt * calls[0]
            ms, counts[f"{label}_health_2x2"], _ = end_path(base, t0, want)
        finally:
            setattr(mod, name, real)
        if label not in RCOND:                       # 3x run alone
            RCOND[label] = true_rcond(
                (S1 if label == "potrf" else A1).to_dense().double())
        rcond = RCOND[label]
        say(f"  {label}(health=True) Grid(2,2): info {rep.info}, growth "
            f"{rep.growth:.6e}, true rcond {rcond:.6e} (ratio "
            f"{rep.growth / rcond:.4f}, bounds [1 - 1e-4, 10]), "
            f"{calls[0]} condest solves, ms {ms:.1f}")
        assert rep.info == 0 and rep.growth is not None
        assert rcond * (1 - 1e-4) <= rep.growth <= 10 * rcond
    return counts


def phase_pq_utils():
    """3x (utils): every generator kind at 4096/256 (structured 2048) on
    2×4 bit for bit the Grid(1, 1) matrix; add, scale, scale_row_col and
    set_matrix on 2×4 equal to 1×1 bit for bit."""
    import slate_tpu_torch as st
    from slate_tpu_torch.utils import generator as gen_mod
    g1, g24 = st.Grid(1, 1), st.Grid(2, 4)
    kinds = gen_mod.FORMULA_KINDS + gen_mod._RANDOM_KINDS + \
        gen_mod._STRUCTURED_KINDS
    for kind in kinds:
        n = GEN_STRUCT_N if kind in gen_mod._STRUCTURED_KINDS else GEN_N
        x, y = (st.generate_matrix(kind, n, nb=GEN_NB, grid=g, seed=5,
                                   dist="geo") for g in (g24, g1))
        assert x.grid == g24 and torch.equal(x.to_dense(), y.to_dense()), \
            kind
    x, y = (st.random_spd(GEN_N, GEN_NB, g, seed=5) for g in (g24, g1))
    spd_err = rel_err(x.to_dense(), y.to_dense())
    assert spd_err <= 10 * GEN_N * 2.0 ** -24, spd_err
    gen = torch.Generator(device="cuda").manual_seed(46)
    a = torch.randn(GEN_N, GEN_N, generator=gen, device="cuda")
    r, c = (torch.randn(GEN_N, generator=gen, device="cuda")
            for _ in range(2))
    ops = {"add": lambda A: st.add(2.0, A, -0.5, A),
           "scale": lambda A: st.scale(3.0, 7.0, A),
           "scale_row_col": lambda A: st.scale_row_col(r, c, A),
           "set_matrix": lambda A: st.set_matrix(0.25, 2.0, A)}
    for name, op in ops.items():
        x, y = (op(st.Matrix.from_dense(a, nb=GEN_NB, grid=g))
                for g in (g24, g1))
        assert torch.equal(x.to_dense(), y.to_dense()), name
    say(f"  generator on Grid(2,4) {GEN_N}/{GEN_NB} (structured "
        f"{GEN_STRUCT_N}): all {len(kinds)} kinds bit for bit the Grid(1,1)"
        f" matrix; random_spd rel_err {spd_err:.3e}; {', '.join(ops)} on "
        f"Grid(2,4) equal to Grid(1,1) bit for bit")


def phase_pq_complex():
    """3x (complex64): hesv 8192/256, posv 8192/1024 and gesv 8192/256 on
    2×2: info 0, ‖A·X − B‖/(‖A‖·‖X‖) ≤ 10·n·2⁻²⁴, no kernel launched."""
    import slate_tpu_torch as st
    c64 = torch.complex64
    n = PQ_CPLX_N
    g = st.Grid(2, 2)
    gen = torch.Generator(device="cuda").manual_seed(47)
    gc = crandn(gen, n, n)
    h = (gc + gc.mH) / 2
    b = crandn(gen, n, NRHS)
    hpd = h + 4 * n ** 0.5 * torch.eye(n, device="cuda")
    M = lambda t, cls=st.Matrix, nb=AASEN_NB: cls.from_dense(  # noqa: E731
        t, nb=nb, grid=g)
    say(f"  complex64 on Grid(2,2), n={n} nrhs={NRHS}:")
    complex_path(f"hesv nb={AASEN_NB} Grid(2,2)",
                 lambda: solution_info(st.hesv(M(h.tril(),
                                                 st.HermitianMatrix),
                                               M(b))),
                 c64, n, lambda X: (cresidual(h, X.to_dense(), b), ""))
    complex_path(f"posv nb={NB} Grid(2,2)",
                 lambda: solution_info(st.posv(
                     M(hpd, st.HermitianMatrix, NB), M(b, nb=NB))),
                 c64, n, lambda X: (cresidual(hpd, X.to_dense(), b), ""))
    complex_path(f"gesv nb={PQ_LU_NB} Grid(2,2)",
                 lambda: solution_info(st.gesv(M(gc, nb=PQ_LU_NB),
                                               M(b, nb=PQ_LU_NB))),
                 c64, n, lambda X: (cresidual(gc, X.to_dense(), b), ""))


def phase_pq_solvers():
    """3x: p×q inverses, condest, mixed solves and Aasen. Returns the
    launches by path."""
    t = {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        t[name] = time.perf_counter() - t0
        return out

    say("p×q inverses, condest, mixed solves and Aasen:")
    counts = part("aasen", phase_pq_aasen)
    counts.update(part("mixed", phase_pq_mixed))
    counts.update(part("inverses and health", phase_pq_inverses_health))
    part("utils", phase_pq_utils)
    part("complex64", phase_pq_complex)
    say("  3x parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
    return counts


# ---------------------------------------------------------------------------
# 3y: the band routines and band BLAS on p×q grids; batched and ragged
# serving
# ---------------------------------------------------------------------------

BAND_PQ_CPLX_N = 8192     # 3y: complex64 gbsv and pbsv on 2×2
# 3y: the batched stacks (batch, n, nrhs, nb): the default nb of each order
BATCH_STACKS = ((64, 1024, NRHS, 256), (1024, 256, 1, 128))
BATCH_FAIL = 16           # 3y: the stack with failing members, at n = 1024
RAGGED_COUNT = 256        # 3y: the ragged requests
RAGGED_N = (97, 2039)     # 3y: their odd orders


def band_outputs(out):
    """The tensors of a band routine's outputs, matrices as dense."""
    flat = []
    for x in (out if isinstance(out, tuple) else (out,)):
        if hasattr(x, "ab"):                      # a band factor
            flat += [t for t in x if isinstance(t, torch.Tensor)]
        elif hasattr(x, "to_dense"):
            flat.append(x.to_dense())
        else:
            flat.append(torch.as_tensor(x))
    return flat


def band_pq_case(label, make, fn, expect, grids, check):
    """One band routine on Grid(1, 1) and on each p×q grid of ``grids``
    (a warm-up call on 1×1 first), each with its launch counts exactly
    ``expect`` (1×1's); every p×q output bit for bit the 1×1 output;
    ``check(out)`` within its bound. Returns the launches by grid."""
    import slate_tpu_torch as st
    fn(*make(st.Grid(1, 1)))                     # warm-up
    outs, launches = pq_beside_one(label, make, fn,
                                   {g: expect for g in ((1, 1),) + grids},
                                   grids)
    one = band_outputs(outs[(1, 1)])
    for g in grids:
        assert same_outputs(band_outputs(outs[g]), one), (label, g)
    check(outs[grids[-1]])
    return launches[grids[-1]]


def phase_pq_band():
    """3y (band): gbsv at 3m's shape on 2×4, pbsv at 3r's on 2×2, gbmm,
    hbmm both sides and tbsm (Left Lower with pivots, Right Upper) at
    3r's on 2×4, complex64 gbsv and pbsv at 8192 on 2×2; each beside
    Grid(1, 1), bit for bit, with 1×1's launches and 3m's or 3r's
    bounds."""
    import slate_tpu_torch as st
    n, kd, nb = N, BAND_KL, AASEN_NB
    gen = torch.Generator(device="cuda").manual_seed(150)
    a = band_matrix(n, kd, kd, 151)
    s = spd_band(n, kd, 152)
    h = (a + a.T) / 2
    t = a.tril()
    t.diagonal().copy_(t.abs().sum(1) + 1.0)
    b = torch.randn(n, NRHS, generator=gen, device="cuda")
    bt = b.T.contiguous()
    limit = 10 * n * 2.0 ** -24
    counts = {}
    say(f"p×q band routines f32 n={n} kl=ku=kd={kd} nb={nb} nrhs={NRHS}, "
        f"each beside Grid(1,1):")

    def mk(*parts):
        return lambda g: tuple(p(g) for p in parts)

    A = lambda g: st.BandMatrix.from_dense(a, nb=nb, grid=g, kl=kd, ku=kd)  # noqa: E731
    S = lambda g: st.HermitianBandMatrix.from_dense(  # noqa: E731
        s.tril(), nb=nb, grid=g, kl=kd, ku=kd)
    H = lambda g: st.HermitianBandMatrix.from_dense(  # noqa: E731
        h.tril(), nb=nb, grid=g, kl=kd, ku=kd)
    T = lambda g: st.TriangularBandMatrix.from_dense(t, nb=nb, grid=g,  # noqa: E731
                                                     kl=kd, ku=0)
    U = lambda g: st.TriangularBandMatrix.from_dense(  # noqa: E731
        t.T.contiguous(), nb=nb, grid=g, kl=0, ku=kd, uplo=st.Uplo.Upper)
    Bm = lambda g: st.Matrix.from_dense(b, nb=nb, grid=g)  # noqa: E731
    Bt = lambda g: st.Matrix.from_dense(bt, nb=nb, grid=g)  # noqa: E731

    def solve_check(mat, rhs, right=False, tight=False):
        def check(out):
            x = (out[0] if isinstance(out, tuple) else out).to_dense()
            r = band_solve_residual(mat.double(), x, rhs, right)
            say(f"    residual {r:.3e} (bound {limit:.3e})")
            assert r <= (min(limit, 2.0 ** -24) if tight else limit), r
        return check

    def prod_check(ref):
        def check(out):
            err = rel_err(out.to_dense(), ref)
            bnd = 10 * (2 * kd + 1) * 2.0 ** -24
            say(f"    rel_err {err:.3e} (bound {bnd:.3e})")
            assert err <= bnd, err
        return check

    panels = -(-n // 96)
    counts["gbsv_pq"] = band_pq_case(
        "gbsv Grid(2,4)", mk(A, Bm), st.gbsv,
        {"rank_k_tail_pallas": panels}, ((2, 4),), solve_check(a, b))
    blocks = n // 32
    counts["pbsv_pq"] = band_pq_case(
        "pbsv Grid(2,2)", mk(S, Bm), st.pbsv,
        {"potrf_tile": blocks, "trsm_right_lower_t": blocks,
         "trsm_left_lower": blocks}, ((2, 2),), solve_check(s, b, tight=True))
    zero = lambda g: st.Matrix.zeros(n, NRHS, nb, g)  # noqa: E731
    zero_t = lambda g: st.Matrix.zeros(NRHS, n, nb, g)  # noqa: E731
    a64, h64 = a.double(), h.double()
    band_pq_case("gbmm Grid(2,4)", mk(A, Bm, zero),
                 lambda A_, B_, C_: st.gbmm(1.0, A_, B_, 0.0, C_), {},
                 ((2, 4),), prod_check(a64 @ b.double()))
    band_pq_case("hbmm Left Grid(2,4)", mk(H, Bm, zero),
                 lambda H_, B_, C_: st.hbmm(st.Side.Left, 1.0, H_, B_, 0.0,
                                            C_), {},
                 ((2, 4),), prod_check(h64 @ b.double()))
    band_pq_case("hbmm Right Grid(2,4)", mk(H, Bt, zero_t),
                 lambda H_, B_, C_: st.hbmm(st.Side.Right, 1.0, H_, B_, 0.0,
                                            C_), {},
                 ((2, 4),), prod_check(bt.double() @ h64))
    piv = torch.clamp(torch.arange(n, device="cuda") + torch.randint(
        0, kd + 1, (n,), generator=gen, device="cuda"), max=n - 1)
    piv = piv.int().reshape(n // nb, nb)
    counts["tbsm_piv_pq"] = band_pq_case(
        "tbsm Left Lower pivots Grid(2,4)", mk(T, Bm),
        lambda T_, B_: st.tbsm(st.Side.Left, 1.0, T_, B_, pivots=piv),
        {"trsm_left_lower": n // 32}, ((2, 4),),
        solve_check(t, b[_sim_perm_host(piv, n)], tight=True))
    band_pq_case("tbsm Right Upper Grid(2,4)", mk(U, Bt),
                 lambda U_, B_: st.tbsm(st.Side.Right, 1.0, U_, B_), {},
                 ((2, 4),), solve_check(t.T, bt, right=True, tight=True))
    # complex64 on 2×2: torch.linalg panels, no kernel
    nc = BAND_PQ_CPLX_N
    gc = torch.Generator(device="cuda").manual_seed(153)
    i = torch.arange(nc, device="cuda")
    inband = (i[None, :] - i[:, None]).abs() <= kd
    ac = torch.where(inband, crandn(gc, nc, nc), 0)
    hc = (ac + ac.mH) / 2
    hc.diagonal().copy_(hc.abs().sum(1) + 1.0)
    bc = crandn(gc, nc, NRHS)
    say(f"  complex64 n={nc} kl=ku=kd={kd} on Grid(2,2):")

    def cres(mat):
        def check(out):
            r = cresidual(mat, out[0].to_dense(), bc)
            say(f"    residual {r:.3e} (bound {10 * nc * 2.0 ** -24:.3e})")
            assert r <= 10 * nc * 2.0 ** -24, r
        return check
    band_pq_case(
        "complex64 gbsv Grid(2,2)",
        lambda g: (st.BandMatrix.from_dense(ac, nb=nb, grid=g, kl=kd, ku=kd),
                   st.Matrix.from_dense(bc, nb=nb, grid=g)),
        st.gbsv, {}, ((2, 2),), cres(ac))
    band_pq_case(
        "complex64 pbsv Grid(2,2)",
        lambda g: (st.HermitianBandMatrix.from_dense(hc.tril(), nb=nb,
                                                     grid=g, kl=kd, ku=kd),
                   st.Matrix.from_dense(bc, nb=nb, grid=g)),
        st.pbsv, {}, ((2, 2),), cres(hc))
    return counts


def batched_backward_error(a, x, b):
    """Each member's ‖A·X − B‖_F/(‖A‖_F·‖X‖_F) in f64 on the card."""
    a, x, b = a.double(), x.double(), b.double()
    r = torch.linalg.norm(a @ x - b, dim=(1, 2))
    return r / (torch.linalg.norm(a, dim=(1, 2))
                * torch.linalg.norm(x, dim=(1, 2)))


def batched_stack(batch, n, nrhs, seed):
    """An SPD stack G·Gᵀ/n + I, a general stack whose pivots are set by a
    row permutation of a dominant diagonal (each member its own, so the
    pivot order is the same in every run), and right-hand sides."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(batch, n, n, generator=gen, device="cuda")
    with _f32():
        spd = g @ g.mT / n + torch.eye(n, device="cuda")
    rows = torch.argsort(torch.rand(batch, n, generator=gen, device="cuda"),
                         dim=1)
    gen_a = torch.take_along_dim(
        torch.randn(batch, n, n, generator=gen, device="cuda")
        + 4 * n ** 0.5 * torch.eye(n, device="cuda"), rows[:, :, None], 1)
    b = torch.randn(batch, n, nrhs, generator=gen, device="cuda")
    return spd, gen_a, b


def phase_batched():
    """3y (batched): posv_batched, gesv_batched, batched_potrf and
    batched_trsm on the two stacks of BATCH_STACKS beside the library's
    batched calls (and, for the first stack, a loop of Grid(1, 1)
    posv/gesv), with exact launch counts, every member's backward error
    and 4 members against their batch-of-1 calls."""
    import slate_tpu_torch as st
    from slate_tpu_torch.serve import batched
    counts = {}
    for si, (batch, n, nrhs, nb) in enumerate(BATCH_STACKS):
        spd, gen_a, b = batched_stack(batch, n, nrhs, 160 + si)
        limit = 10 * n * 2.0 ** -24
        say(f"batched f32 [{batch}, {n}, {n}] nrhs={nrhs} nb={nb}:")
        kt = n // nb
        for label, fn, expect in (
                ("posv_batched", lambda: st.posv_batched(spd, b),
                 {"potrf_tile": kt}),
                ("gesv_batched", lambda: st.gesv_batched(gen_a, b), {}),
                ("batched_potrf", lambda: batched.batched_potrf(spd),
                 {"potrf_tile": kt}),
                ("batched_trsm", lambda: batched.batched_trsm(spd.tril(), b),
                 {})):
            if (label == "batched_potrf" and si) or \
                    (label == "batched_trsm" and not si):
                continue
            fn()                                 # warm-up
            base, t0 = start_path()
            out = fn()
            _, launches, peak = end_path(base, t0, expect)
            counts[f"{label}_{n}"] = launches
            ms = time_ms(fn, reps=3)
            say(f"  {label}: ms {ms:.3f}, {batch / ms * 1e3:.0f} solves/s, "
                f"peak device memory above its inputs {peak:.3f} GiB")
            if label in ("posv_batched", "gesv_batched"):
                x, info = out[0], out[-1]
                a = spd if label == "posv_batched" else gen_a
                err = batched_backward_error(a, x, b)
                say(f"    info all 0 {not bool(info.any())}, backward error "
                    f"max {float(err.max()):.3e} (bound {limit:.3e})")
                assert not info.any() and float(err.max()) <= limit
                assert bool(torch.isfinite(x).all())
                single = (st.posv_batched if label == "posv_batched"
                          else st.gesv_batched)
                for i in (0, batch // 3, batch // 2, batch - 1):
                    one = single(a[i:i + 1], b[i:i + 1])
                    d = float((one[0][0] - x[i]).abs().max()
                              / x[i].abs().max())
                    assert d <= 5 * limit, (label, i, d)
                    if label == "gesv_batched":
                        assert torch.equal(one[2][0], out[2][i]), i
                say(f"    members 0, {batch // 3}, {batch // 2}, {batch - 1}"
                    f" within {5 * limit:.3e} of their batch-of-1 calls"
                    + (", perm equal" if label == "gesv_batched" else ""))
            elif label == "batched_potrf":
                l, info = out
                with _f32():
                    rec = float((torch.linalg.norm(l @ l.mT - spd, dim=(1, 2))
                                 / torch.linalg.norm(spd, dim=(1, 2))).max())
                say(f"    |L L^T - A|/|A| max {rec:.3e} (bound {limit:.3e})")
                assert not info.any() and rec <= limit
            else:
                with _f32():
                    r = float((torch.linalg.norm(spd.tril() @ out - b,
                                                 dim=(1, 2))
                               / (torch.linalg.norm(spd.tril(), dim=(1, 2))
                                  * torch.linalg.norm(out, dim=(1, 2)))).max())
                say(f"    backward error max {r:.3e} (bound {limit:.3e})")
                assert r <= limit
        with _f32():
            lib = {
                "cholesky_ex + cholesky_solve": lambda: torch.cholesky_solve(
                    b, torch.linalg.cholesky_ex(spd)[0]),
                "lu_factor_ex + lu_solve": lambda: torch.linalg.lu_solve(
                    *torch.linalg.lu_factor_ex(gen_a)[:2], b),
                "cholesky_ex": lambda: torch.linalg.cholesky_ex(spd),
                "solve_triangular": lambda: torch.linalg.solve_triangular(
                    spd.tril(), b, upper=False)}
            for name, f in lib.items():
                ms = time_ms(f, reps=3)
                say(f"  library {name}: ms {ms:.3f}, "
                    f"{batch / ms * 1e3:.0f} solves/s")
        if si == 0:
            g = st.Grid(1, 1)
            mats = [(st.HermitianMatrix.from_dense(spd[i], nb=nb, grid=g),
                     st.Matrix.from_dense(gen_a[i], nb=nb, grid=g),
                     st.Matrix.from_dense(b[i], nb=nb, grid=g))
                    for i in range(batch)]
            for name, f in (("posv", lambda H_, A_, B_: st.posv(H_, B_)),
                            ("gesv", lambda H_, A_, B_: st.gesv(A_, B_))):
                f(*mats[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for m in mats:
                    f(*m)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                say(f"  loop of {batch} Grid(1,1) {name} at nb={nb}: ms "
                    f"{ms:.3f}, {batch / ms * 1e3:.0f} solves/s")
            del mats
        del spd, gen_a, b
    return counts


def phase_batched_failure():
    """3y (failure in a stack): BATCH_FAIL members at n = 1024, one with a
    NaN tile, one not positive definite, one singular: posv_batched and
    gesv_batched give those members the CPU's info, every X finite, the
    other members within the bound."""
    import slate_tpu_torch as st
    n, nb = 1024, 256
    spd, _, b = batched_stack(BATCH_FAIL, n, NRHS, 170)
    a = spd.clone()
    a[3, :2, :2] = float("nan")                # a NaN tile
    a[7, 600, 600] = -1e3                      # not positive definite
    a[11, :, 300] = 0.0                        # singular
    a[11, 300, :] = 0.0
    limit = 10 * n * 2.0 ** -24
    bad = (3, 7, 11)
    for label, fn in (("posv_batched", st.posv_batched),
                      ("gesv_batched", st.gesv_batched)):
        out = fn(a, b)
        ref = fn(a.cpu(), b.cpu())
        x, info, info_cpu = out[0], out[-1].cpu(), ref[-1]
        err = batched_backward_error(a, x, b)
        ok_rows = [i for i in range(BATCH_FAIL)
                   if i not in bad and int(info[i]) == 0]
        say(f"  failure stack {label} [{BATCH_FAIL}, {n}, {n}]: info "
            f"{info.tolist()} (CPU {info_cpu.tolist()}), X finite "
            f"{bool(torch.isfinite(x).all())}, others' backward error max "
            f"{float(err[ok_rows].max()):.3e} (bound {limit:.3e})")
        assert torch.equal(info, info_cpu)
        assert all(int(info[i]) == 0 for i in range(BATCH_FAIL)
                   if i not in bad)
        assert int(info[3]) > 0 and int(info[11]) > 0
        assert (int(info[7]) > 0) == (label == "posv_batched")
        assert bool(torch.isfinite(x).all())
        assert float(err[ok_rows].max()) <= limit


def ragged_requests(seed):
    """RAGGED_COUNT requests of seeded odd orders in RAGGED_N, posv and
    gesv alternating, 1–8 right-hand sides (one as a 1-D b), made on the
    card; the host copies for the requests and the card copies for the
    checks."""
    from slate_tpu_torch.serve import SolveRequest
    rng = np.random.default_rng(seed)
    ns = 2 * rng.integers(RAGGED_N[0] // 2, RAGGED_N[1] // 2 + 1,
                          size=RAGGED_COUNT) + 1
    ks = rng.integers(1, 9, size=RAGGED_COUNT)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reqs, cards = [], []
    for i, (n, k) in enumerate(zip(ns.tolist(), ks.tolist())):
        g = torch.randn(n, n, generator=gen, device="cuda")
        if i % 2 == 0:
            with _f32():
                a = g @ g.T / n + torch.eye(n, device="cuda")
        else:
            a = g
        b = torch.randn(n, k, generator=gen, device="cuda")
        if k == 1:
            b = b[:, 0]
        cards.append((a, b))
        reqs.append(SolveRequest(a=a.cpu().numpy(), b=b.cpu().numpy(),
                                 routine="posv" if i % 2 == 0 else "gesv",
                                 tag=i))
    return reqs, cards


def ragged_errors(res, cards, idx):
    """Each result's backward error on the card, in f64."""
    out = []
    for r, i in zip(res, idx):
        a, b = (t.double() for t in cards[i])
        x = torch.from_numpy(r.x).to("cuda").double()
        x2, b2 = x.reshape(a.shape[0], -1), b.reshape(a.shape[0], -1)
        out.append(float(torch.linalg.norm(a @ x2 - b2)
                         / (torch.linalg.norm(a) * torch.linalg.norm(x2))))
    return out


def phase_ragged():
    """3y (ragged): solve_ragged on RAGGED_COUNT requests over the default
    bucket table: order kept, each bucket bucket_for's, x shaped as b,
    each backward error within 10·bucket·2⁻²⁴; groups × rungs, the wall
    time, requests/s and the padded-waste share. Then one group again
    under ``nan_tile:seed=5``: exactly one request unhealthy, its
    batchmates within the bound."""
    from slate_tpu_torch import obs
    from slate_tpu_torch.cache import buckets
    from slate_tpu_torch.robust import faults
    from slate_tpu_torch.serve import solve_ragged
    reqs, cards = ragged_requests(180)
    obs.metrics_on()
    try:
        with faults.inject():
            solve_ragged(reqs[:2])               # warm-up
            obs.reset()
            t0 = time.perf_counter()
            res = solve_ragged(reqs)
            wall = time.perf_counter() - t0
        waste = {(e["labels"]["routine"], int(e["labels"]["bucket"])):
                 e["value"] for e in obs.dump()["gauges"]
                 if e["name"] == "serve.padded_waste_frac"}
        dispatch = obs.metrics.span_seconds_total("serve.dispatch")
    finally:
        obs.metrics_off()
    assert [r.tag for r in res] == [q.tag for q in reqs]
    errs = ragged_errors(res, cards, range(len(reqs)))
    rungs = {}
    for q, r, e in zip(reqs, res, errs):
        assert r.health.ok and r.bucket == buckets.bucket_for(q.a.shape[0])
        assert r.x.shape == q.b.shape
        assert e <= 10 * r.bucket * 2.0 ** -24, (q.tag, r.bucket, e)
        rungs.setdefault((q.routine, r.bucket), []).append(r.rung)
    plan = {k: sorted(set(v), reverse=True) for k, v in sorted(rungs.items())}
    say(f"ragged: {len(reqs)} requests, orders {RAGGED_N[0]}–{RAGGED_N[1]}, "
        f"{len(plan)} groups: " + "; ".join(
            f"{r} {bk}: {len(rungs[(r, bk)])} as rungs {v}"
            for (r, bk), v in plan.items()))
    say(f"  wall {wall * 1e3:.1f} ms, {len(reqs) / wall:.1f} requests/s, "
        f"of it in serve.dispatch spans (the batched solves and their "
        f"copies to the host) {dispatch * 1e3:.1f} ms "
        f"({dispatch / wall:.3f}), the rest grouping, padding and "
        f"cropping on the host; "
        f"backward error max {max(errs):.3e}; serve.padded_waste_frac "
        + ", ".join(f"{r} {bk}: {w:.3f}" for (r, bk), w in
                    sorted(waste.items())))
    # the fault corrupts one member a group: run the largest posv group
    bucket = max((bk for r, bk in rungs if r == "posv"),
                 key=lambda bk: len(rungs[("posv", bk)]))
    sub = [q for q, r in zip(reqs, res)
           if q.routine == "posv" and r.bucket == bucket]
    with faults.inject("nan_tile:seed=5"):
        fres = solve_ragged(sub)
    unhealthy = [r.tag for r in fres if not r.health.ok]
    ferr = ragged_errors([r for r in fres if r.health.ok], cards,
                         [r.tag for r in fres if r.health.ok])
    say(f"  nan_tile:seed=5 on the {len(sub)} posv requests of bucket "
        f"{bucket}: unhealthy {unhealthy} (member {5 % len(sub)}), "
        f"batchmates' backward error max {max(ferr):.3e}")
    assert unhealthy == [sub[5 % len(sub)].tag]
    assert all(np.isfinite(r.x).all() for r in fres)
    assert max(ferr) <= 10 * bucket * 2.0 ** -24


def phase_pq_band_serving():
    """3y: the band routines and band BLAS on p×q grids, and batched and
    ragged serving. Returns the launches by path."""
    t = {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        t[name] = time.perf_counter() - t0
        return out

    say("p×q band routines and serving:")
    counts = part("band", phase_pq_band)
    counts.update(part("batched", phase_batched))
    part("failure", phase_batched_failure)
    part("ragged", phase_ragged)
    say("  3y parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
    return counts


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import slate_tpu_torch  # noqa: F401 — fails outside a checkout
    for flag in ("SLATE_LU_FAST", "SLATE_LU_FOLD", "SLATE_QR_FAST",
                 "SLATE_QR_PANEL"):
        os.environ.pop(flag, None)
    smi = timed("1 toolchain", phase_toolchain)
    rows = timed("2 kernels", phase_kernels)
    rows.update(timed("2b LU kernels", phase_lu_kernels))
    rows.update(timed("2c QR and unpivoted-LU kernels",
                      phase_qr_nopiv_kernels))
    rows.update(timed("2d bulge-chase kernels", phase_chase_kernels))
    rows.update(timed("2e Aasen and band LU kernels",
                      phase_swap_rank_k_kernels))
    timed("2f tier products", phase_tier_products)
    rows.update(timed("2g stein kernel", phase_stein_kernel))
    counts = {"posv": timed("3 posv", phase_main_path)}
    nt = N // NB
    counts["gesv"] = timed(
        "3b gesv", run_gesv, N, NB, 3,
        {"plu_call_folded_block": nt * NB // 128, "fold_panel": nt,
         "unfold_panel": nt, "trsm_left_lower": nt}, "LU main path", True)
    ft = FLAT_N // FLAT_NB
    counts["gesv_flat"] = timed(
        "3c gesv flat", run_gesv, FLAT_N, FLAT_NB, 5,
        {"plu_call": ft * FLAT_NB // 128, "transpose_tiled": 2 * ft,
         "trsm_left_lower": ft}, "LU flat branch")
    counts["plu_panel"] = timed("3d plu_panel", phase_plu_panel)
    counts["geqrf"] = timed("3e geqrf", phase_geqrf)
    timed("3f gels", phase_gels)
    counts["gesv_nopiv"] = timed("3g gesv_nopiv", phase_gesv_nopiv)
    counts["heev_vals"] = timed("3h heev values", phase_heev_vals)
    timed("3i heev vectors", phase_heev_vectors)
    counts["gesvd_vals"] = timed("3j gesvd values", phase_gesvd_vals)
    timed("3k gesvd vectors", phase_gesvd_vectors)
    counts["hesv"] = timed("3l hesv", phase_hesv)
    counts["gbsv"] = timed("3m gbsv", phase_gbsv)
    counts.update(timed("3n mixed solves", phase_mixed))
    counts["hetrf_health"] = timed("3o norms, condest and health",
                                   phase_norms_health)
    timed("3p inverses", phase_inverses)
    timed("3q potrf 32k by tier", phase_potrf_32k)
    counts.update(timed("3r BLAS, band BLAS, pbsv and hegv",
                        phase_blas_band_hegv))
    counts.update(timed("3s LAPACK API, stein, CALU and the dense entries",
                        phase_lapack_stein_calu))
    counts.update(timed("3v p×q grids on one card", phase_pq))
    counts.update(timed("3w p×q least squares and two-stage",
                        phase_pq_two_stage))
    counts.update(timed("3x p×q inverses, condest, mixed and hesv",
                        phase_pq_solvers))
    counts.update(timed("3y p×q band and batched serving",
                        phase_pq_band_serving))
    timed("4 failure report", phase_failure_report)
    timed("4b LU failure report", phase_lu_failure_report)
    timed("4c QR and unpivoted-LU failure report",
          phase_qr_nopiv_failure_report)
    timed("4d eig/svd failure report", phase_eig_failure_report)
    timed("4e Aasen/band failure report", phase_aasen_band_failure_report)
    timed("4f mixed-precision failure report", phase_mixed_failure_report)
    timed("4g band Cholesky and hegv failure report",
          phase_band_hegv_failure_report)
    timed("4h LAPACK API and CALU failure report",
          phase_lapack_calu_failure_report)
    phase_complex_utils()
    counts.update(phase_complex_two_stage())
    out = []
    for name, (source, replaces, path) in KERNELS.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": counts[path][name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    # K1 over a stack: its launches on 3y's batched paths and its times
    k1 = next(o for o in out if o["name"] == "potrf_tile")
    k1["batched_launches"] = {
        k: v["potrf_tile"] for k, v in counts.items()
        if k.startswith(("posv_batched", "batched_potrf"))}
    k1["stacks"] = rows["potrf_tile"]["stacks"]
    say(json.dumps({"kernels": out}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
