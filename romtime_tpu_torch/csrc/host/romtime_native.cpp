// Native host kernels of the port (romtime_tpu_torch/native.py):
//
//   * greedy DEIM interpolation-point selection — a data-dependent
//     argmax/solve recursion, O(Ns^2 * Nh), sequential by nature; the
//     numpy recursion of deim/deim.py is its plain version;
//   * a single-system tridiagonal (Thomas) solve for host-side checks.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, with fom_piston.cpp, into
// build/native/libromtime_native.so (native.py, at first use).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Greedy ties: deim/deim.py TIE_RTOL.
constexpr double TIE_RTOL = 1e-10;

// Solve a dense k x k system in place (partial pivoting). A is row-major,
// overwritten; b overwritten with the solution. Returns 0 on success.
int solve_dense(double* A, double* b, int64_t k) {
    std::vector<int64_t> piv(k);
    for (int64_t i = 0; i < k; ++i) piv[i] = i;

    for (int64_t col = 0; col < k; ++col) {
        // pivot
        int64_t best = col;
        double best_val = std::fabs(A[col * k + col]);
        for (int64_t r = col + 1; r < k; ++r) {
            double v = std::fabs(A[r * k + col]);
            if (v > best_val) { best = r; best_val = v; }
        }
        if (best_val == 0.0) return 1;
        if (best != col) {
            for (int64_t c = 0; c < k; ++c)
                std::swap(A[col * k + c], A[best * k + c]);
            std::swap(b[col], b[best]);
        }
        const double inv = 1.0 / A[col * k + col];
        for (int64_t r = col + 1; r < k; ++r) {
            const double f = A[r * k + col] * inv;
            if (f == 0.0) continue;
            for (int64_t c = col; c < k; ++c) A[r * k + c] -= f * A[col * k + c];
            b[r] -= f * b[col];
        }
    }
    for (int64_t r = k - 1; r >= 0; --r) {
        double acc = b[r];
        for (int64_t c = r + 1; c < k; ++c) acc -= A[r * k + c] * b[c];
        b[r] = acc / A[r * k + r];
    }
    return 0;
}

}  // namespace

extern "C" {

// Greedy DEIM point selection.
//
// Vf        : (nh x ns) basis, row-major.
// forbidden : nf dof indices excluded from selection (Dirichlet-convention
//             positions whose basis value vanishes by construction).
// out_dofs  : ns selected dof indices.
//
// Returns 0 on success, nonzero on a singular intermediate system.
int deim_greedy(const double* Vf, int64_t nh, int64_t ns,
                const int64_t* forbidden, int64_t nf, int64_t* out_dofs) {
    std::vector<uint8_t> banned(nh, 0);
    for (int64_t i = 0; i < nf; ++i) {
        if (forbidden[i] >= 0 && forbidden[i] < nh) banned[forbidden[i]] = 1;
    }

    // The first allowed position within TIE_RTOL of the largest |v|
    // (deim/deim.py's tie rule): entries equal up to rounding pick the
    // same dof here and in the numpy recursion.
    auto masked_argmax = [&](const double* v) {
        double best_val = -1.0;
        for (int64_t i = 0; i < nh; ++i) {
            if (banned[i]) continue;
            const double a = std::fabs(v[i]);
            if (a > best_val) best_val = a;
        }
        if (best_val < 0.0) return int64_t(-1);
        const double floor = best_val * (1.0 - TIE_RTOL);
        for (int64_t i = 0; i < nh; ++i) {
            if (!banned[i] && std::fabs(v[i]) >= floor) return i;
        }
        return int64_t(-1);
    };

    // Warm-up with the first basis column.
    std::vector<double> column(nh);
    for (int64_t i = 0; i < nh; ++i) column[i] = Vf[i * ns + 0];
    int64_t dof = masked_argmax(column.data());
    if (dof < 0) return 2;
    out_dofs[0] = dof;

    std::vector<double> M;       // (k x k) interpolation matrix U[dofs, :k]
    std::vector<double> rhs;     // k
    std::vector<double> coeff;   // k
    std::vector<double> residual(nh);

    for (int64_t j = 1; j < ns; ++j) {
        const int64_t k = j;
        // M[r][c] = Vf[out_dofs[r], c],  rhs[r] = Vf[out_dofs[r], j]
        M.assign(k * k, 0.0);
        rhs.assign(k, 0.0);
        for (int64_t r = 0; r < k; ++r) {
            const double* row = Vf + out_dofs[r] * ns;
            for (int64_t c = 0; c < k; ++c) M[r * k + c] = row[c];
            rhs[r] = row[j];
        }
        coeff = rhs;
        if (solve_dense(M.data(), coeff.data(), k) != 0) return 1;

        // residual = Vf[:, j] - Vf[:, :k] @ coeff
        for (int64_t i = 0; i < nh; ++i) {
            const double* row = Vf + i * ns;
            double acc = row[j];
            for (int64_t c = 0; c < k; ++c) acc -= row[c] * coeff[c];
            residual[i] = acc;
        }
        dof = masked_argmax(residual.data());
        if (dof < 0) return 2;
        out_dofs[j] = dof;
    }
    return 0;
}

// Thomas tridiagonal solve, single system (host verification path).
// lower/diag/upper/rhs length n; x output length n.
int thomas_solve(const double* lower, const double* diag, const double* upper,
                 const double* rhs, int64_t n, double* x) {
    std::vector<double> cp(n), dp(n);
    double m = diag[0];
    if (m == 0.0) return 1;
    cp[0] = upper[0] / m;
    dp[0] = rhs[0] / m;
    for (int64_t i = 1; i < n; ++i) {
        m = diag[i] - lower[i] * cp[i - 1];
        if (m == 0.0) return 1;
        cp[i] = upper[i] / m;
        dp[i] = (rhs[i] - lower[i] * dp[i - 1]) / m;
    }
    x[n - 1] = dp[n - 1];
    for (int64_t i = n - 2; i >= 0; --i) x[i] = dp[i] - cp[i] * x[i + 1];
    return 0;
}

}  // extern "C"
