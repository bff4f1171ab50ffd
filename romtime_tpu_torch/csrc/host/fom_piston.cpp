// Native moving-piston FOM time loop (host, float64).
//
// The port's certification-grade f64 offline sweep: the eager torch loop
// pays a few hundred small launches a step (on the card as on the host),
// where this loop runs the same algebra in tens of milliseconds a
// trajectory at nx=1000/nt=1500.
//
// Algebra replicated from romtime_tpu_torch/fom/{base,nonlinear}.py
// (_solve_impl + OneDimensionalBurgers.assemble_*):
//
//   step k (t = (k+1)·dt), BDF-2 with zero history start:
//     bdf  = k>0 ? 1.5 : 1.0
//     u*   = 2·u_n − u_n1
//     K    = bdf·M + dt·(A + C + N(u*) + N̂)      (each Dirichlet-applied)
//     b    = M·(2·u_n − ½·u_n1) + dt·f_g          (f_g Dirichlet-zeroed)
//     solve K u = b  (tridiagonal Thomas; the eager loop uses PCR — the
//     same solution to roundoff)
//
//   with (piston one-sided lifting g = bL·x/L, s = Lt(t), r = L̇t/Lt):
//     M  = h·M₁                       h = h0·s
//     A  = (α/h)·A₁
//     C  = −a0·C₁ − r·s·Cx            (c(x) = −(a0 + x_phys·r))
//     N̂  = (b0·bL/L0)·Cx + (h0·b0·bL/L0)·M₁     (s cancels in the 0,0 term)
//     N  = b0 · Σ_l u*_loc[l] · T[l]  (per-element 2×2×2 tensor)
//     f_g = h·(γ0·v0 + γ1·v1) + c1·d1, γ0 = a0·bL/(L0·s),
//           γ1 = −dbL/L0 − b0·bL²/(L0²·s) + r·bL/L0, c1 = −α·bL/(L0·s)
//
// Unit bands M₁/A₁/C₁/Cx and vectors v0/v1/d1 are assembled once by the
// same 4-point Gauss rule as ops/element.py (degree 1).
// Dirichlet convention: right-end row only (the piston defines only bL),
// row zeroed with unit diagonal PER OPERATOR — so the combined K carries
// bdf + 4·dt on the Dirichlet diagonal, matching fom/base.py
// _assemble_matrix + nonlinear.py assemble_system term by term.
//
// Build: compiled with romtime_native.cpp into build/native/
// libromtime_native.so by romtime_tpu_torch/native.py.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// 4-point Gauss-Legendre on [0, 1] (ops/element.py, 4 points).
constexpr int NQ = 4;
const double QX[NQ] = {
    0.5 * (1.0 - 0.8611363115940526),
    0.5 * (1.0 - 0.3399810435848563),
    0.5 * (1.0 + 0.3399810435848563),
    0.5 * (1.0 + 0.8611363115940526),
};
const double QW[NQ] = {
    0.5 * 0.3478548451374538,
    0.5 * 0.6521451548625461,
    0.5 * 0.6521451548625461,
    0.5 * 0.3478548451374538,
};

struct UnitTables {
    // Banded (3, nh) unit operators: band[d][r] = A[r][r + d - 1].
    std::vector<double> M1, A1, C1, Cx;
    // Unit load vectors.
    std::vector<double> v0, v1, d1;
    // Trilinear element tensor T[l][i][j] = Σ_q w_q·P_l·P'_j·P_i  (h^0).
    double T[2][2][2];
    int64_t nh;
};

inline double P(int i, double xi) { return i == 0 ? 1.0 - xi : xi; }
inline double dP(int i) { return i == 0 ? -1.0 : 1.0; }

// Assemble the µ-independent unit tables (h = 1 reference scaling).
UnitTables build_unit_tables(int64_t ne, double h0) {
    UnitTables t;
    const int64_t nh = ne + 1;
    t.nh = nh;
    t.M1.assign(3 * nh, 0.0);
    t.A1.assign(3 * nh, 0.0);
    t.C1.assign(3 * nh, 0.0);
    t.Cx.assign(3 * nh, 0.0);
    t.v0.assign(nh, 0.0);
    t.v1.assign(nh, 0.0);
    t.d1.assign(nh, 0.0);

    for (int l = 0; l < 2; ++l)
        for (int i = 0; i < 2; ++i)
            for (int j = 0; j < 2; ++j) {
                double acc = 0.0;
                for (int q = 0; q < NQ; ++q)
                    acc += QW[q] * P(l, QX[q]) * dP(j) * P(i, QX[q]);
                t.T[l][i][j] = acc;
            }

    for (int64_t e = 0; e < ne; ++e) {
        for (int i = 0; i < 2; ++i) {
            const int64_t row = e + i;
            double acc_v0 = 0.0, acc_v1 = 0.0, acc_d1 = 0.0;
            for (int q = 0; q < NQ; ++q) {
                const double xr = h0 * (static_cast<double>(e) + QX[q]);
                acc_v0 += QW[q] * P(i, QX[q]);
                acc_v1 += QW[q] * xr * P(i, QX[q]);
                acc_d1 += QW[q] * dP(i);
            }
            t.v0[row] += acc_v0;
            t.v1[row] += acc_v1;
            t.d1[row] += acc_d1;
            for (int j = 0; j < 2; ++j) {
                const int64_t d = j - i + 1;  // band row
                double m = 0.0, a = 0.0, c = 0.0, cx = 0.0;
                for (int q = 0; q < NQ; ++q) {
                    const double xr = h0 * (static_cast<double>(e) + QX[q]);
                    const double pi = P(i, QX[q]), pj = P(j, QX[q]);
                    m += QW[q] * pj * pi;
                    a += QW[q] * dP(j) * dP(i);
                    c += QW[q] * dP(j) * pi;
                    cx += QW[q] * xr * dP(j) * pi;
                }
                t.M1[d * nh + row] += m;
                t.A1[d * nh + row] += a;
                t.C1[d * nh + row] += c;
                t.Cx[d * nh + row] += cx;
            }
        }
    }
    return t;
}

// Thomas solve of the tridiagonal band (3, nh): band[d][r] = K[r][r+d-1].
// Overwrites work arrays; rhs -> solution in x.
void thomas(const double* band, const double* rhs, double* x,
            double* cp, double* dp, int64_t nh) {
    const double* lo = band;            // K[r][r-1]
    const double* di = band + nh;       // K[r][r]
    const double* up = band + 2 * nh;   // K[r][r+1]
    cp[0] = up[0] / di[0];
    dp[0] = rhs[0] / di[0];
    for (int64_t r = 1; r < nh; ++r) {
        const double m = 1.0 / (di[r] - lo[r] * cp[r - 1]);
        cp[r] = up[r] * m;
        dp[r] = (rhs[r] - lo[r] * dp[r - 1]) * m;
    }
    x[nh - 1] = dp[nh - 1];
    for (int64_t r = nh - 2; r >= 0; --r) x[r] = dp[r] - cp[r] * x[r + 1];
}

}  // namespace

extern "C" {

// Full piston FOM time loop. Returns 0 on success.
//
//   s_arr, r_arr, bL_arr, dbL_arr : (nt,) per-step scalars evaluated at
//       t = (k+1)·dt by fom/native_sweep.py from the problem's Lt/dLt_dt
//       and Dirichlet callables (keeps the kernel general for any
//       piston-family problem definition).
//   u0       : (nh,) homogeneous initial state.
//   nl_rows/nl_cols : trilinear snapshot topology (band entries of the
//       Dirichlet-applied N operator, fom/nonlinear.py setup()).
//   uh_out   : (nt, nh) homogeneous solution per step.
//   nl_out   : (nt, n_nl) gathered trilinear snapshot per step.
int piston_fom_solve(
    double L0, int64_t nx, int64_t nt, double dt,
    double a0, double alpha, double b0,
    const double* s_arr, const double* r_arr,
    const double* bL_arr, const double* dbL_arr,
    const double* u0,
    const int64_t* nl_rows, const int64_t* nl_cols, int64_t n_nl,
    double* uh_out, double* nl_out) {
    const int64_t ne = nx;
    const int64_t nh = ne + 1;
    const double h0 = L0 / static_cast<double>(nx);

    static thread_local UnitTables tables;
    static thread_local int64_t tables_ne = -1;
    static thread_local double tables_h0 = 0.0;
    if (tables_ne != ne || tables_h0 != h0) {
        tables = build_unit_tables(ne, h0);
        tables_ne = ne;
        tables_h0 = h0;
    }
    const UnitTables& U = tables;

    std::vector<double> u_n(u0, u0 + nh), u_n1(nh, 0.0);
    std::vector<double> ustar(nh), Nband(3 * nh), Kband(3 * nh), rhs(nh);
    std::vector<double> cp(nh), dpv(nh), u(nh);

    for (int64_t k = 0; k < nt; ++k) {
        const double bdf = (k > 0) ? 1.5 : 1.0;
        const double s = s_arr[k];
        const double r = r_arr[k];
        const double bL = bL_arr[k];
        const double dbL = dbL_arr[k];
        const double h = h0 * s;

        for (int64_t i = 0; i < nh; ++i)
            ustar[i] = 2.0 * u_n[i] - u_n1[i];

        // Trilinear band N(u*) = b0·Σ_l u*_loc[l]·T[l]  (a=1, b=0, h^0).
        for (int64_t i = 0; i < 3 * nh; ++i) Nband[i] = 0.0;
        for (int64_t e = 0; e < ne; ++e) {
            const double ul0 = ustar[e], ul1 = ustar[e + 1];
            for (int i = 0; i < 2; ++i) {
                const int64_t row = e + i;
                for (int j = 0; j < 2; ++j) {
                    const int64_t d = j - i + 1;
                    Nband[d * nh + row] +=
                        b0 * (ul0 * U.T[0][i][j] + ul1 * U.T[1][i][j]);
                }
            }
        }
        // Dirichlet on N (right end only): zero row, unit diagonal.
        Nband[0 * nh + (nh - 1)] = 0.0;
        Nband[1 * nh + (nh - 1)] = 1.0;
        Nband[2 * nh + (nh - 1)] = 0.0;

        // K = bdf·M + dt·(A + C + N + N̂), closed-form linear parts.
        const double cm = bdf * h;                       // · M1
        const double ca = dt * alpha / h;                // · A1
        const double cc = dt * (-a0);                    // · C1
        const double ccx = dt * (-r * s + b0 * bL / L0); // · Cx
        const double cnh = dt * h0 * b0 * bL / L0;       // · M1 (N̂ 0,0 term)
        for (int64_t i = 0; i < 3 * nh; ++i)
            Kband[i] = (cm + cnh) * U.M1[i] + ca * U.A1[i] + cc * U.C1[i] +
                       ccx * U.Cx[i] + dt * Nband[i];
        // Dirichlet row of K: every constituent operator carries a unit
        // diagonal after its own Dirichlet application (M, A, C, N̂, N).
        Kband[0 * nh + (nh - 1)] = 0.0;
        Kband[1 * nh + (nh - 1)] = bdf + 4.0 * dt;
        Kband[2 * nh + (nh - 1)] = 0.0;

        // rhs = M_dir·(2u_n − ½u_n1) + dt·f_g.
        const double g0 = a0 * bL / (L0 * s);
        const double g1 = -dbL / L0 - b0 * bL * bL / (L0 * L0 * s) +
                          r * bL / L0;
        const double c1 = -alpha * bL / (L0 * s);
        // banded matvec with M = h·M1 (Dirichlet row handled after).
        for (int64_t i = 0; i < nh; ++i) {
            double acc = U.M1[1 * nh + i] * (2.0 * u_n[i] - 0.5 * u_n1[i]);
            if (i > 0)
                acc += U.M1[0 * nh + i] * (2.0 * u_n[i - 1] - 0.5 * u_n1[i - 1]);
            if (i < nh - 1)
                acc += U.M1[2 * nh + i] * (2.0 * u_n[i + 1] - 0.5 * u_n1[i + 1]);
            double fg = h * (g0 * U.v0[i] + g1 * U.v1[i]) + c1 * U.d1[i];
            rhs[i] = h * acc + dt * fg;
        }
        // Dirichlet: M_dir row picks the state entry; f_g zeroed.
        rhs[nh - 1] = 2.0 * u_n[nh - 1] - 0.5 * u_n1[nh - 1];

        thomas(Kband.data(), rhs.data(), u.data(), cp.data(), dpv.data(), nh);

        double* uh_k = uh_out + k * nh;
        for (int64_t i = 0; i < nh; ++i) uh_k[i] = u[i];
        if (n_nl > 0) {
            double* nl_k = nl_out + k * n_nl;
            for (int64_t m = 0; m < n_nl; ++m) {
                const int64_t row = nl_rows[m];
                const int64_t d = nl_cols[m] - row + 1;
                nl_k[m] = Nband[d * nh + row];
            }
        }

        u_n1 = u_n;
        u_n = u;
    }
    return 0;
}

}  // extern "C"
