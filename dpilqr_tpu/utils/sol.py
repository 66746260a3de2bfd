"""Work models for the iLQR sweeps: FLOPs and device-memory bytes.

Device-neutral counts of the arithmetic and memory traffic one sweep must
do, computed from shapes alone.  A benchmark divides them by a measured
kernel time to get achieved rates, and by a device's published peaks
(kept with the benchmark, keyed by ``device_kind``) to get roofline
shares.  Nothing here measures anything.

All counts use MAC = 2 FLOPs and count the one-hot blend arithmetic of
the Gauss-Jordan solve (it occupies the ALUs just like the "useful"
FLOPs).
"""

from __future__ import annotations


def backward_step_flops(K: int, nx_p: int, nu_p: int) -> int:
    """FLOPs of ONE time step of the Riccati backward sweep for ONE
    subproblem, counted on the block-diagonal structure of ``A``/``B``
    (ops/ilqr._backward_pass); nxf = K*nx_p, nuf = K*nu_p.
    """
    nxf, nuf = K * nx_p, K * nu_p
    fl = 0
    fl += 2 * nxf * nxf  # Preg = P + mu * eye (mul + add per entry)
    fl += 2 * K * nx_p * nx_p + nxf  # Q_x = Lx + A_bd^T p
    fl += 2 * K * nx_p * nu_p + nuf  # Q_u = Lu + B_bd^T p
    fl += 2 * nx_p * nxf * nxf  # AtP = A_bd^T P
    fl += 2 * nx_p * nxf * nxf + nxf * nxf  # Q_xx = Lxx + AtP A_bd
    fl += 2 * nx_p * nuf * nxf  # W1 = B_bd^T Preg
    fl += 2 * nx_p * nuf * nxf  # Q_ux = W1 A_bd
    fl += 2 * nx_p * nuf * nuf + nuf * nuf  # Q_uu = W1 B_bd + Luu
    # _gj_solve: nuf pivots.  Per pivot over the (nuf + nxf + 1)-wide
    # augmented system: scale row (w mul), eliminate (2 w nuf), restore
    # via one-hot blends (~4 w: two muls, one sub, one add).
    w = nuf + nxf + 1
    fl += nuf * (w + 2 * w * nuf + 4 * w)
    fl += 2 * nuf * nuf + nuf  # w = Q_uu d + Q_u
    fl += 2 * nuf * nxf * 2 + 2 * nxf  # p' = Q_x + K^T w + Q_ux^T d
    fl += 2 * nuf * nuf * nxf  # QuuK = Q_uu K
    # K^T QuuK + K^T Q_ux; Q_ux^T K is the TRANSPOSE of the latter (no
    # FLOPs -- the kernel reuses the contraction).
    fl += 2 * (2 * nuf * nxf * nxf)
    fl += 3 * nxf * nxf  # adds + symmetrization
    return fl


def backward_step_hbm_bytes(
    K: int, nx_p: int, nu_p: int, dtype_bytes: int = 4
) -> int:
    """Device-memory bytes per time step per subproblem of a fused backward
    sweep: the per-step inputs (A, B, L_uu, L_xx, L_x, L_u) and outputs
    (K, d).  The value-function state stays on chip and is not counted."""
    nxf, nuf = K * nx_p, K * nu_p
    n_in = (
        K * nx_p * nx_p  # A
        + K * nx_p * nu_p  # B
        + nuf * nuf  # L_uu (block-diag embedded dense)
        + nxf * nxf  # L_xx
        + nxf  # L_x
        + nuf  # L_u
    )
    n_out = nuf * nxf + nuf  # Kg, d
    return (n_in + n_out) * dtype_bytes


def forward_step_trig_ops(
    K: int, nx_p: int, nu_p: int, n_alpha: int, substeps: int,
    f_trig_per_slot: int = 2,
) -> int:
    """Transcendental (sin/cos/tan) evaluations of ONE time step of the
    line-search rollout for ONE subproblem across its n_alpha candidates:
    ``4 * substeps`` dynamics evals, each issuing ``f_trig_per_slot``
    transcendentals per slot (Unicycle4D: cos + sin of the heading,
    models/vectorized.py:56-57).

    Counted SEPARATELY from ``forward_step_flops`` because hardware issues
    transcendentals at a lower rate than fused multiply-adds."""
    C = K * n_alpha
    return substeps * 4 * f_trig_per_slot * C


def forward_step_flops(
    K: int, nx_p: int, nu_p: int, n_alpha: int, substeps: int,
    f_flops_per_slot: int = 40,
) -> int:
    """FLOPs of ONE time step of the line-search rollout for ONE
    subproblem, across its n_alpha candidates.

    ``f_flops_per_slot``: cost of one continuous-dynamics eval per slot
    (model-dependent; ~40 covers the trig + affine work of the 4-state
    models, models/vectorized.py).  Transcendentals are ALSO counted at
    their true issue rate via ``forward_step_trig_ops`` (the ~2 ops of
    overlap out of 40 keeps this count conservative).
    """
    nxf, nuf = K * nx_p, K * nu_p
    C = K * n_alpha  # columns per subproblem
    fl = 0
    fl += 2 * nxf * nuf * n_alpha  # du = sum_k G dx (outer-product FMAs)
    fl += 2 * nu_p * nuf * C  # du row extraction (0/1 matmul)
    fl += 3 * nu_p * C  # u = Ur + du + alpha * d
    # stage cost: two quadforms (Q e, R u) + mask/weight muls
    fl += (2 * nx_p * nx_p + 2 * nx_p) * C
    fl += (2 * nu_p * nu_p + 2 * nu_p) * C
    fl += 6 * C
    npairs = K * (K - 1) // 2
    fl += npairs * (3 * 3 * 2 + 8) * n_alpha  # pairwise penalty columns
    # RK4: 4 f evals + state combines per substep
    fl += substeps * (4 * f_flops_per_slot + 14 * nx_p) * C
    return fl


def forward_step_hbm_bytes(
    K: int, nx_p: int, nu_p: int, n_alpha: int, dtype_bytes: int = 4
) -> int:
    """Device-memory bytes per time step per subproblem of a fused rollout:
    Xr, Ur, G, d in; Xo, Uo out (constants loaded once)."""
    nxf, nuf = K * nx_p, K * nu_p
    C = K * n_alpha
    n = (
        nx_p * C  # Xr
        + nu_p * C  # Ur
        + nxf * nuf  # G (per subproblem, not per alpha)
        + nu_p * C  # d tiled
        + nx_p * C  # Xo
        + nu_p * C  # Uo
    )
    return n * dtype_bytes


def pscan_sweep_flops(N: int, nxf: int) -> int:
    """FLOPs of one associative-scan Riccati sweep (ops/pscan.py).

    The combine does 8 dense (nxf, nxf) matmuls (TA1, C1@TA1,
    A2@M1A1, A1^T@TA1, TC1, C1@TC1, A2@M1C1, @A2^T: 2*nxf^3 each) plus
    ONE Gauss-Jordan pass over the (nxf, 2*nxf+1)-augmented system
    (~3 matmul-equivalents of elimination + blend work); matvecs are
    negligible.  ``associative_scan`` executes ~2N combines across its
    up/down sweeps."""
    return 2 * N * 11 * 2 * nxf**3
