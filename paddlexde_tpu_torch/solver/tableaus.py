"""Embedded Runge-Kutta Butcher tableaus (pure math constants).

The port's own copy of ``paddlexde_tpu/solver/tableaus.py``: the same
classical published data (Bogacki-Shampine 1989, Fehlberg 1969,
Dormand-Prince-Shampine 1980/1986, Hairer's DOP853, Tsitouras 2011, the
ESDIRKs), kept as float64 numpy constants and cast to the state's dtype
where the engine uses them. The tsit5 midpoint weights and the sdirk4
embedded weights are derived at import, as in the JAX package.

``beta`` is one dense, zero-padded ``[S-1, S]`` lower-triangular matrix, so
a stage combination is one contraction against the ``[S, ...]`` stage
buffer. The implicit tableaus (kvaerno3, sdirk4, trbdf2) carry their
diagonals in ``diag``; ``adaptive.make_rk_core`` solves those stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ButcherTableau", "TABLEAUS"]


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    name: str
    order: int
    alpha: np.ndarray  # [S-1] stage times (fractions of dt)
    beta: np.ndarray  # [S-1, S] zero-padded stage-combination matrix
    c_sol: np.ndarray  # [S] solution weights
    c_error: np.ndarray  # [S] error-estimate weights
    c_mid: np.ndarray  # [S] dense-output midpoint weights
    # [S] per-stage diagonal for (E)SDIRK tableaus (None = explicit). For
    # stage i > 0, the engine solves Y_i = y0 + dt*(beta[i-1]·k) + dt*diag[i]
    # * f(t_i, Y_i) by Newton instead of an explicit evaluation; beta rows
    # hold only the EXPLICIT part (a_ij, j < i).
    diag: "np.ndarray | None" = None

    @property
    def n_stages(self) -> int:
        return self.c_sol.shape[0]

    @property
    def implicit(self) -> bool:
        return self.diag is not None

    @property
    def fsal(self) -> bool:
        """First-same-as-last: y1 equals the last stage input (Dormand–Prince)."""
        if self.diag is not None:
            return False
        return bool(
            self.c_sol[-1] == 0.0 and np.allclose(self.c_sol[:-1], self.beta[-1, :-1])
        )


def _tableau(name, order, alpha, beta_rows, c_sol, c_error, c_mid):
    s = len(c_sol)
    beta = np.zeros((len(beta_rows), s), dtype=np.float64)
    for i, row in enumerate(beta_rows):
        beta[i, : len(row)] = row
    return ButcherTableau(
        name=name,
        order=order,
        alpha=np.asarray(alpha, np.float64),
        beta=beta,
        c_sol=np.asarray(c_sol, np.float64),
        c_error=np.asarray(c_error, np.float64),
        c_mid=np.asarray(c_mid, np.float64),
    )


ADAPTIVE_HEUN = _tableau(
    "adaptive_heun",
    2,
    alpha=[1.0],
    beta_rows=[[1.0]],
    c_sol=[0.5, 0.5],
    c_error=[0.5, -0.5],
    c_mid=[0.5, 0.0],
)

FEHLBERG2 = _tableau(
    "fehlberg2",
    2,
    alpha=[1 / 2, 1.0],
    beta_rows=[[1 / 2], [1 / 256, 255 / 256]],
    c_sol=[1 / 512, 255 / 256, 1 / 512],
    c_error=[-1 / 512, 0.0, 1 / 512],
    c_mid=[0.0, 0.5, 0.0],
)

BOSH3 = _tableau(
    "bosh3",
    3,
    alpha=[1 / 2, 3 / 4, 1.0],
    beta_rows=[[1 / 2], [0.0, 3 / 4], [2 / 9, 1 / 3, 4 / 9]],
    c_sol=[2 / 9, 1 / 3, 4 / 9, 0.0],
    c_error=[2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8],
    c_mid=[0.0, 0.5, 0.0, 0.0],
)

DOPRI5 = _tableau(
    "dopri5",
    5,
    alpha=[1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
    beta_rows=[
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ],
    c_sol=[35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
    c_error=[
        35 / 384 - 1951 / 21600,
        0.0,
        500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720,
        -2187 / 6784 + 12231 / 42400,
        11 / 84 - 649 / 6300,
        -1.0 / 60.0,
    ],
    c_mid=[
        6025192743 / 30085553152 / 2,
        0.0,
        51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2,
        187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2,
        11237099 / 235043384 / 2,
    ],
)


def _dopri8() -> ButcherTableau:
    """Hairer's 8(7) Dormand–Prince tableau, 14 stages.

    Constants as in Hairer–Nørsett–Wanner and the reference's
    ``adaptive_solver/dopri8.py:5-153``. The c_mid entries are each stage's
    degree-5 dense-output polynomial evaluated at the step midpoint h = 1/2
    times h (reference ``dopri8.py:155-238``).
    """
    A = [1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
         5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1.0, 1.0, 1.0]
    B = [
        [1 / 18],
        [1 / 48, 1 / 16],
        [1 / 32, 0.0, 3 / 32],
        [5 / 16, 0.0, -75 / 64, 75 / 64],
        [3 / 80, 0.0, 0.0, 3 / 16, 3 / 20],
        [29443841 / 614563906, 0.0, 0.0, 77736538 / 692538347, -28693883 / 1125000000, 23124283 / 1800000000],
        [16016141 / 946692911, 0.0, 0.0, 61564180 / 158732637, 22789713 / 633445777, 545815736 / 2771057229, -180193667 / 1043307555],
        [39632708 / 573591083, 0.0, 0.0, -433636366 / 683701615, -421739975 / 2616292301, 100302831 / 723423059, 790204164 / 839813087, 800635310 / 3783071287],
        [246121993 / 1340847787, 0.0, 0.0, -37695042795 / 15268766246, -309121744 / 1061227803, -12992083 / 490766935, 6005943493 / 2108947869, 393006217 / 1396673457, 123872331 / 1001029789],
        [-1028468189 / 846180014, 0.0, 0.0, 8478235783 / 508512852, 1311729495 / 1432422823, -10304129995 / 1701304382, -48777925059 / 3047939560, 15336726248 / 1032824649, -45442868181 / 3398467696, 3065993473 / 597172653],
        [185892177 / 718116043, 0.0, 0.0, -3185094517 / 667107341, -477755414 / 1098053517, -703635378 / 230739211, 5731566787 / 1027545527, 5232866602 / 850066563, -4093664535 / 808688257, 3962137247 / 1805957418, 65686358 / 487910083],
        [403863854 / 491063109, 0.0, 0.0, -5068492393 / 434740067, -411421997 / 543043805, 652783627 / 914296604, 11173962825 / 925320556, -13158990841 / 6184727034, 3936647629 / 1978049680, -160528059 / 685178525, 248638103 / 1413531060, 0.0],
        [14005451 / 335480064, 0.0, 0.0, 0.0, 0.0, -59238493 / 1068277825, 181606767 / 758867731, 561292985 / 797845732, -1041891430 / 1371343529, 760417239 / 1151165299, 118820643 / 751138087, -528747749 / 2220607170, 1 / 4],
    ]
    C_sol = [14005451 / 335480064, 0.0, 0.0, 0.0, 0.0, -59238493 / 1068277825,
             181606767 / 758867731, 561292985 / 797845732, -1041891430 / 1371343529,
             760417239 / 1151165299, 118820643 / 751138087, -528747749 / 2220607170,
             1 / 4, 0.0]
    C_err = [
        14005451 / 335480064 - 13451932 / 455176623, 0.0, 0.0, 0.0, 0.0,
        -59238493 / 1068277825 + 808719846 / 976000145,
        181606767 / 758867731 - 1757004468 / 5645159321,
        561292985 / 797845732 - 656045339 / 265891186,
        -1041891430 / 1371343529 + 3867574721 / 1518517206,
        760417239 / 1151165299 - 465885868 / 322736535,
        118820643 / 751138087 - 53011238 / 667516719,
        -528747749 / 2220607170 - 2 / 45,
        1 / 4, 0.0,
    ]

    # Dense-output polynomial coefficients per stage: [p5, p4, p3, p2, p1, p0]
    # (degree-5 in h), evaluated via Horner at h = 1/2, then scaled by h.
    h = 0.5
    CPOLY = {
        0: [-6.3448349392860401388, 22.1396504998094068976, -30.0610568289666450593, 19.9990069333683970610, -6.6910181737837595697, 1.0],
        5: [-39.6107919852202505218, 116.4422149550342161651, -121.4999627731334642623, 52.2273532792945524050, -7.6142658045872677172, 0.0],
        6: [20.3761213808791436958, -67.1451318825957197185, 83.1721004639847717481, -46.8919164181093621583, 10.7281392630428866124, 0.0],
        7: [7.3347098826795362023, -16.5672243527496524646, 9.5724507555993664382, -0.1890893225010595467, 0.5526637063753648783, 0.0],
        8: [32.8801774352459155182, -89.9916014847245016028, 87.8406057677205645007, -35.7075975946222072821, 4.2186562625665153803, 0.0],
        9: [-10.1588990526426760954, 22.6237489648532849093, -17.4152107770762969005, 6.2736448083240352160, -0.6627209125361597559, 0.0],
        10: [-12.5401268098782561200, 32.2362340167355370113, -28.5903289514790976966, 10.3160881272450748458, -1.2636789001135462218, 0.0],
        11: [29.5553001484516038033, -82.1020315488359848644, 81.6630950584341412934, -34.7650769866611817349, 5.4106037898590422230, 0.0],
        12: [-41.7923486424390588923, 116.2662185791119533462, -114.9375291377009418170, 47.7457971078225540396, -7.0321379067945741781, 0.0],
        13: [20.3006925822100825485, -53.9020777466385396792, 50.2558364226176017553, -19.0082099341608028453, 2.3537586759714983486, 0.0],
    }
    c_mid = [0.0] * 14
    for i, poly in CPOLY.items():
        val = 0.0
        for coef in poly:
            val = val * h + coef
        c_mid[i] = val * h
    return _tableau("dopri8", 8, A, B, C_sol, C_err, c_mid)


DOPRI8 = _dopri8()


def _tsit5() -> ButcherTableau:
    """Tsitouras 5(4) (Tsitouras 2011, "Runge–Kutta pairs of order 5(4)
    satisfying only the first column simplifying assumption"): 7 stages, FSAL,
    order 5 with an embedded order-4 estimator. The modern default explicit
    pair (Julia's ``Tsit5``): same stage count as Dormand–Prince but smaller
    error constants — measured here ~2-3x less error than dopri5 at equal
    grids (tests/solver/test_tsit5.py). No counterpart exists in the
    reference's zoo (``paddlexde/solver/adaptive_solver/*``); capability add.

    The a/b/btilde constants are published data. Rather than also
    transcribing the paper's dense-output polynomials, the midpoint weights
    c_mid are DERIVED at import: solve the eight order-4 interpolation
    conditions at theta = 1/2 (trees 1, c, c^2, Ac, c^3, c*Ac, Ac^2, AAc with
    rhs theta, theta^2/2, theta^3/3, theta^3/6, theta^4/4, theta^4/8,
    theta^4/12, theta^4/24) by least squares — the system is CONSISTENT for
    this tableau (residual ~1e-16, asserted), so the solution is a genuine
    4th-order midpoint, matching the accuracy the quartic dense-output engine
    assumes. All 17 order-5 conditions + embedded order are pinned in tests.
    """
    c = np.array([0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0])
    b = np.array([
        0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
        -3.290069515436081, 2.324710524099774, 0.0,
    ])
    beta_rows = [
        [0.161],
        [-0.008480655492356989, 0.335480655492357],
        [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
        [5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525],
        [5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383],
        list(b[:-1]),  # FSAL: last stage row = solution weights
    ]
    # error weights = b - bhat (OrdinaryDiffEq's btilde; bhat passes every
    # order-4 condition and fails order 5 — pinned in tests)
    c_error = np.array([
        -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
        -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
        1.0 / 66.0,
    ])
    A = np.zeros((7, 7))
    for i, row in enumerate(beta_rows):
        A[i + 1, : len(row)] = row
    Ac = A @ c
    th = 0.5
    M = np.stack([np.ones(7), c, c**2, Ac, c**3, c * Ac, A @ c**2, A @ Ac])
    rhs = np.array([th, th**2 / 2, th**3 / 3, th**3 / 6, th**4 / 4,
                    th**4 / 8, th**4 / 12, th**4 / 24])
    c_mid, *_ = np.linalg.lstsq(M, rhs, rcond=None)
    resid = float(np.abs(M @ c_mid - rhs).max())
    assert resid < 1e-12, f"tsit5 midpoint conditions inconsistent: {resid}"
    return _tableau("tsit5", 5, list(c[1:]), beta_rows, list(b), list(c_error),
                    list(c_mid))


TSIT5 = _tsit5()


def _kvaerno3():
    """Kvaerno(4,2,3): 4-stage stiffly-accurate ESDIRK, L-stable, order 3 with
    an embedded order-2 (also stiffly-accurate) error estimator (A. Kvaerno,
    BIT 2004, "Singly diagonally implicit Runge-Kutta methods with an explicit
    first stage"). All coefficients derive in closed form from gamma, the
    middle root of 6g^3 - 18g^2 + 9g - 1 = 0 (the choice that makes the
    4-stage method order 3 AND L-stable):

        c = [0, 2g, 1, 1],   diagonal = [0, g, g, g]
        a32 = (1 - 2g)/(4g),           a31 = 1 - g - a32       (embedded b^)
        b2  = -1/(12 g (2g - 1)),      b3 = 1/2 - g - 2g b2,   b1 = 1-g-b2-b3
        b^  = [a31, a32, g, 0],        error weights = b - b^

    Dense-output midpoint weights (3rd-order b(1/2) interpolant) from the
    collocation conditions at theta = 1/2: m2 = 1/(24 g (1 - 2g)),
    m3 + m4 = 1/8 - 2g m2 (split evenly; the b.A.c condition is then
    satisfied identically), m1 = 1/2 - m2 - m3 - m4. All order/embedded/
    L-stability properties are pinned algebraically and by measured
    convergence in tests/solver/test_implicit_adaptive.py.
    """
    roots = np.roots([6.0, -18.0, 9.0, -1.0])
    g = float(np.sort(roots[np.isreal(roots)].real)[1])  # middle root ~0.4359
    a32 = (1.0 - 2.0 * g) / (4.0 * g)
    a31 = 1.0 - g - a32
    b2 = -1.0 / (12.0 * g * (2.0 * g - 1.0))
    b3 = 0.5 - g - 2.0 * g * b2
    b1 = 1.0 - g - b2 - b3
    b = [b1, b2, b3, g]
    b_hat = [a31, a32, g, 0.0]
    m2 = 1.0 / (24.0 * g * (1.0 - 2.0 * g))
    m34 = 0.125 - 2.0 * g * m2
    c_mid = [0.5 - m2 - m34, m2, m34 / 2.0, m34 / 2.0]
    tab = _tableau(
        "kvaerno3",
        3,
        alpha=[2.0 * g, 1.0, 1.0],
        beta_rows=[[g], [a31, a32], [b1, b2, b3]],  # explicit parts only
        c_sol=b,
        c_error=[bi - bhi for bi, bhi in zip(b, b_hat)],
        c_mid=c_mid,
    )
    return dataclasses.replace(tab, diag=np.asarray([0.0, g, g, g], np.float64))


KVAERNO3 = _kvaerno3()


def _trbdf2():
    """TR-BDF2 as a stiffly-accurate ESDIRK (Bank et al. 1985; the SPICE /
    Hosea–Shampine workhorse): a trapezoidal half-step composed with BDF2,
    one-step, L-stable, order 2, with an order-3 embedded error estimator.
    Every coefficient is closed form in γ = 1 − √2/2:

        c = [0, 2γ, 1],  diagonal = [0, γ, γ]
        A = [[0,0,0], [γ, γ, 0], [√2/4, √2/4, γ]],   b = A's last row
        b̂ solves the three order-3 quadrature conditions
          (Σb̂, Σb̂c, Σb̂c²) = (1, 1/2, 1/3):  b̂₂ = (1/6)/(2γ(1−2γ)),
          b̂₃ = 1/2 − 2γ b̂₂,  b̂₁ = 1 − b̂₂ − b̂₃;  error weights = b − b̂.
        Dense-output midpoint weights from (Σm, Σmc, Σmc²) =
          (1/2, 1/8, 1/24) — a third-order interpolant at θ = 1/2.

    Stiff accuracy (b = last row) gives R(−∞) = 0; pinned with measured
    order and stiff behaviour in tests/solver/test_implicit_adaptive.py.
    """
    g = 1.0 - np.sqrt(2.0) / 2.0
    w = np.sqrt(2.0) / 4.0
    b = [w, w, g]
    bh2 = (1.0 / 6.0) / (2.0 * g * (1.0 - 2.0 * g))
    bh3 = 0.5 - 2.0 * g * bh2
    bh1 = 1.0 - bh2 - bh3
    m2 = (1.0 / 12.0) / (2.0 * g * (1.0 - 2.0 * g))
    m3 = 0.125 - 2.0 * g * m2
    m1 = 0.5 - m2 - m3
    tab = _tableau(
        "trbdf2",
        2,
        alpha=[2.0 * g, 1.0],
        beta_rows=[[g], [w, w]],  # explicit parts only; diag carries γ
        c_sol=b,
        c_error=[bi - bhi for bi, bhi in zip(b, [bh1, bh2, bh3])],
        c_mid=[m1, m2, m3],
    )
    return dataclasses.replace(tab, diag=np.asarray([0.0, g, g], np.float64))


TRBDF2 = _trbdf2()


def _sdirk4():
    """Hairer–Wanner's 5-stage SDIRK, γ = 1/4: L-stable, stiffly accurate,
    order 4 (HNW II, the classical "SDIRK4"). Unlike the ESDIRKs above the
    FIRST stage is implicit (diag[0] = γ; its abscissa is c1 = a11 = γ by the
    row-sum convention — the adaptive engine's dirk loop handles it).

    The a/b constants are published rational data; all eight order-4
    conditions and R(−∞) = 0 are pinned in tests. The embedded order-3
    weights b̂ and the θ = 1/2 dense-output weights are DERIVED at import as
    the least-norm solutions of their (consistent, underdetermined) order
    conditions — residuals asserted, and b̂ is checked to genuinely FAIL
    order 4 (a b̂ accidentally of order 4 would zero the error estimate).

    NB: for this 5-stage family the error-weight DIRECTION is forced (the
    order-3 conditions' nullspace is one-dimensional), and its entries are
    large (±4) — in f32 the error combination cancels O(1) stage values to
    read an O(h⁴) signal, so at very tight tolerances the noise floor can
    dt-underflow (observed on-chip at rtol 1e-7: the backward adjoint solve
    underflowed; gradients now come back NaN rather than silently
    truncated). On f32 hardware use rtol ≳ 1e-5 or adjoint_solver
    "kvaerno3"/"dopri5"; f64 is unaffected.
    """
    g = 0.25
    beta_rows = [
        [1.0 / 2.0],
        [17.0 / 50.0, -1.0 / 25.0],
        [371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0],
        [25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0],
    ]
    b = np.array([25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, g])
    a_mat = np.zeros((5, 5))
    for i, row in enumerate(beta_rows):
        a_mat[i + 1, : len(row)] = row
    np.fill_diagonal(a_mat, g)
    c = a_mat.sum(1)  # [1/4, 3/4, 11/20, 1/2, 1]
    ac = a_mat @ c
    cond = np.stack([np.ones(5), c, c**2, ac])
    b_hat, *_ = np.linalg.lstsq(cond, np.array([1.0, 0.5, 1 / 3, 1 / 6]),
                                rcond=None)
    assert float(np.abs(cond @ b_hat - [1.0, 0.5, 1 / 3, 1 / 6]).max()) < 1e-12
    assert abs(b_hat @ c**3 - 0.25) > 1e-3  # embedded must FAIL order 4
    th = 0.5
    m, *_ = np.linalg.lstsq(
        cond, np.array([th, th**2 / 2, th**3 / 3, th**3 / 6]), rcond=None
    )
    assert float(np.abs(cond @ m - [th, th**2 / 2, th**3 / 3, th**3 / 6]).max()) < 1e-12
    tab = _tableau(
        "sdirk4", 4,
        alpha=list(c[1:]),
        beta_rows=beta_rows,
        c_sol=list(b),
        c_error=list(b - b_hat),
        c_mid=list(m),
    )
    return dataclasses.replace(tab, diag=np.full(5, g))


SDIRK4 = _sdirk4()

TABLEAUS = {
    "adaptive_heun": ADAPTIVE_HEUN,
    "fehlberg2": FEHLBERG2,
    "bosh3": BOSH3,
    "dopri5": DOPRI5,
    "dopri8": DOPRI8,
    "tsit5": TSIT5,
    "kvaerno3": KVAERNO3,
    "sdirk4": SDIRK4,
    "trbdf2": TRBDF2,
}
