// CPU baseline surrogate for the reference BCM3 cell-population likelihood.
//
// The reference (NKI-CCB/bcm3) cannot be built in this image (Boost
// absent), so this tool measures an equivalent CPU implementation of the
// work the reference performs per cellpop likelihood evaluation
// (reference: src/cellpop/Experiment.cpp:635-846): a growing population
// of cells, each integrated by a stiff implicit solver with
// threshold-event detection (cytokinesis > 1 => divide, Cell.cpp:463-531),
// daughters spawned mid-run from a work queue, cell-to-cell variability
// on the division clock, and a time-course score.
//
// The cell model matches tools/bench_cellpop_scaling.py exactly: the base
// 4 dynamic states (mass, cytokinesis clock, active kinase Ka,
// phosphorylated substrate Xp; the "env" species is constant) with a
// stiff kinase/phosphatase module (rates ~1e3-3e3 vs growth ~1e-1), plus
// `modules` extra (Ka_i, Xp_i) cascade stages — NS = 4 + 2*modules ODE
// states, i.e. the 5/21/41-"species" scaling models. The integrator is
// RODAS3 (KPP ros_Rodas3 tableau: 4-stage order-3(2) L-stable Rosenbrock,
// Sandu et al. 1997) with an analytic sparse Jacobian and a per-step
// partial-pivot LU that skips structurally/numerically zero multipliers —
// the CPU-honest analogue of the reference's sparsity-exploiting LU
// (src/utils/EigenPartialPivLUSomewhatSparse.h) so the anchor does not
// strawman the CPU at large species counts.
//
// Scoring modes:
//   population-average (default): normal error model on the per-timepoint
//     population mean (DataLikelihoodTimeCoursePopulationAverage.cpp);
//   matched: per-cell Hungarian minimum-cost matching of observed traces
//     to simulated cell traces (DataLikelihoodTimeCourse.cpp:187-355),
//     solved by the same JV LAP algorithm the JAX path uses
//     (native/lap.cpp; link both files together).
//
// Usage: baseline_cellpop <n_evals> <n_threads> [max_cells] [initial]
//                         [modules] [matched(0|1)]
// Prints one JSON line with evals/sec.
//
// Build: g++ -O3 -march=native -o baseline_cellpop \
//          tools/baseline_cellpop.cpp native/lap.cpp -lpthread

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" double bcm3_lap_solve(int n_rows, int n_cols, const double* cost,
                                 int* row_to_col);

struct Model {
    int modules;  // extra cascade stages
    int ns;       // 4 + 2*modules
    double Ktot = 1.0, Xtot = 1.0;
    double k_act = 2000.0, k_deact = 1000.0, k_phos = 3000.0,
           k_dephos = 1500.0;
};

struct CellParams {
    double k_growth, k_div;  // k_div carries the per-cell variability
};

// State layout: [mass, cytokinesis, Ka, Xp, Ka0, Xp0, Ka1, Xp1, ...]
static inline void rhs(const Model& m, const CellParams& p, const double* y,
                       double* f) {
    f[0] = p.k_growth * y[0] * (1.0 - y[3]);
    f[1] = p.k_div;
    f[2] = m.k_act * y[0] * (m.Ktot - y[2]) - m.k_deact * y[2];
    f[3] = m.k_phos * y[2] * (m.Xtot - y[3]) - m.k_dephos * y[3];
    for (int i = 0; i < m.modules; i++) {
        const int ka = 4 + 2 * i, xp = 5 + 2 * i;
        const double driver = (i == 0) ? y[0] : y[5 + 2 * (i - 1)];
        f[ka] = m.k_act * driver * (m.Ktot - y[ka]) - m.k_deact * y[ka];
        f[xp] = m.k_phos * y[ka] * (m.Xtot - y[xp]) - m.k_dephos * y[xp];
    }
}

// Analytic sparse Jacobian (row-major ns x ns); only structurally
// nonzero entries are written after the memset — the role of the
// reference's generated per-entry Jacobian (SBMLModel.h:28-30).
static inline void jac(const Model& m, const CellParams& p, const double* y,
                       double* J) {
    const int ns = m.ns;
    std::memset(J, 0, sizeof(double) * ns * ns);
    J[0 * ns + 0] = p.k_growth * (1.0 - y[3]);
    J[0 * ns + 3] = -p.k_growth * y[0];
    J[2 * ns + 0] = m.k_act * (m.Ktot - y[2]);
    J[2 * ns + 2] = -m.k_act * y[0] - m.k_deact;
    J[3 * ns + 2] = m.k_phos * (m.Xtot - y[3]);
    J[3 * ns + 3] = -m.k_phos * y[2] - m.k_dephos;
    for (int i = 0; i < m.modules; i++) {
        const int ka = 4 + 2 * i, xp = 5 + 2 * i;
        const int drv = (i == 0) ? 0 : 5 + 2 * (i - 1);
        const double driver = y[drv];
        J[ka * ns + drv] = m.k_act * (m.Ktot - y[ka]);
        J[ka * ns + ka] = -m.k_act * driver - m.k_deact;
        J[xp * ns + ka] = m.k_phos * (m.Xtot - y[xp]);
        J[xp * ns + xp] = -m.k_phos * y[ka] - m.k_dephos;
    }
}

// RODAS3 tableau (KPP ros_Rodas3; public literature, same as the JAX path)
static const double GAMMA = 0.5;
static const double A32 = 2.0, A41 = 2.0, A43 = 1.0;
static const double C21 = 4.0, C31 = 1.0, C32 = -1.0;
static const double C41 = 1.0, C42 = -1.0, C43 = -8.0 / 3.0;
static const double M1 = 2.0, M3 = 1.0, M4 = 1.0;
// embedded error = k4 (E = [0,0,0,1])

// Partial-pivot LU with zero-multiplier skipping: banded/cascade systems
// keep most multipliers exactly zero, so skipping them recovers the
// sparse-LU work profile (EigenPartialPivLUSomewhatSparse.h's trick)
// without a symbolic phase.
struct LU {
    std::vector<double> a;  // ns x ns
    std::vector<int> piv;
    int ns;
};

static bool lu_factor(const double* G, LU& lu, int ns) {
    lu.ns = ns;
    lu.a.assign(G, G + ns * ns);
    lu.piv.resize(ns);
    double* a = lu.a.data();
    for (int k = 0; k < ns; k++) {
        int p = k;
        for (int i = k + 1; i < ns; i++)
            if (std::fabs(a[i * ns + k]) > std::fabs(a[p * ns + k])) p = i;
        lu.piv[k] = p;
        if (p != k)
            for (int j = 0; j < ns; j++)
                std::swap(a[k * ns + j], a[p * ns + j]);
        const double d = a[k * ns + k];
        if (d == 0.0) return false;
        for (int i = k + 1; i < ns; i++) {
            if (a[i * ns + k] == 0.0) continue;  // sparse skip
            const double f = (a[i * ns + k] /= d);
            const double* rk = a + k * ns;
            double* ri = a + i * ns;
            for (int j = k + 1; j < ns; j++) {
                if (rk[j] != 0.0) ri[j] -= f * rk[j];
            }
        }
    }
    return true;
}

static void lu_solve(const LU& lu, double* b) {
    const int ns = lu.ns;
    const double* a = lu.a.data();
    for (int k = 0; k < ns; k++) {
        if (lu.piv[k] != k) std::swap(b[k], b[lu.piv[k]]);
        const double bk = b[k];
        if (bk == 0.0) continue;  // sparse skip
        for (int i = k + 1; i < ns; i++) b[i] -= a[i * ns + k] * bk;
    }
    for (int i = ns - 1; i >= 0; i--) {
        const double* ri = a + i * ns;
        double s = b[i];
        for (int j = i + 1; j < ns; j++) s -= ri[j] * b[j];
        b[i] = s / ri[i];
    }
}

struct Scratch {
    std::vector<double> J, G, f0, k1, k2, k3, k4, yt, r, ynew;
    LU lu;
    void init(int ns) {
        J.resize(ns * ns);
        G.resize(ns * ns);
        f0.resize(ns);
        k1.resize(ns);
        k2.resize(ns);
        k3.resize(ns);
        k4.resize(ns);
        yt.resize(ns);
        r.resize(ns);
        ynew.resize(ns);
    }
};

// One RODAS3 step; returns scaled error norm (autonomous RHS).
static bool rodas3_step(const Model& m, const CellParams& p, double* y,
                        double h, double rtol, double atol, Scratch& s,
                        double* errn) {
    const int ns = m.ns;
    jac(m, p, y, s.J.data());
    const double hg = 1.0 / (h * GAMMA);
    for (int i = 0; i < ns; i++)
        for (int j = 0; j < ns; j++)
            s.G[i * ns + j] = (i == j ? hg : 0.0) - s.J[i * ns + j];
    if (!lu_factor(s.G.data(), s.lu, ns)) return false;

    double* k1 = s.k1.data();
    double* k2 = s.k2.data();
    double* k3 = s.k3.data();
    double* k4 = s.k4.data();
    double* r = s.r.data();
    rhs(m, p, y, s.f0.data());
    // stage 1
    std::memcpy(r, s.f0.data(), sizeof(double) * ns);
    lu_solve(s.lu, r);
    std::memcpy(k1, r, sizeof(double) * ns);
    // stage 2: Y2 = y (A[1][*]=0), rhs = f(y) + C21/h k1
    for (int i = 0; i < ns; i++) r[i] = s.f0[i] + (C21 / h) * k1[i];
    lu_solve(s.lu, r);
    std::memcpy(k2, r, sizeof(double) * ns);
    // stage 3: Y3 = y + A32*k1
    for (int i = 0; i < ns; i++) s.yt[i] = y[i] + A32 * k1[i];
    rhs(m, p, s.yt.data(), r);
    for (int i = 0; i < ns; i++) r[i] += (C31 * k1[i] + C32 * k2[i]) / h;
    lu_solve(s.lu, r);
    std::memcpy(k3, r, sizeof(double) * ns);
    // stage 4: Y4 = y + A41*k1 + A43*k3
    for (int i = 0; i < ns; i++) s.yt[i] = y[i] + A41 * k1[i] + A43 * k3[i];
    rhs(m, p, s.yt.data(), r);
    for (int i = 0; i < ns; i++)
        r[i] += (C41 * k1[i] + C42 * k2[i] + C43 * k3[i]) / h;
    lu_solve(s.lu, r);
    std::memcpy(k4, r, sizeof(double) * ns);

    double e = 0.0;
    for (int i = 0; i < ns; i++) {
        s.ynew[i] = y[i] + M1 * k1[i] + M3 * k3[i] + M4 * k4[i];
        double sc =
            atol + rtol * std::max(std::fabs(y[i]), std::fabs(s.ynew[i]));
        double ee = k4[i] / sc;
        e += ee * ee;
    }
    *errn = std::sqrt(e / ns);
    return std::isfinite(*errn);
}

struct Cell {
    std::vector<double> y;
    double t0;  // global creation time
};

struct Obs {
    std::vector<double> times;               // T
    std::vector<double> observed;            // T (population-average mode)
    std::vector<std::vector<double>> cells;  // n_obs x T (matched mode)
};

// Integrate one cell from its creation to t_end with adaptive RODAS3,
// recording mass at observation times and detecting the cytokinesis>1
// crossing (=> division, children pushed onto the work queue).
// In matched mode the per-cell trace is appended to `traces`.
static bool simulate_cell(const Model& m, const CellParams& p, Cell cell,
                          double t_end, double rtol, double atol,
                          const Obs& obs, std::vector<double>& mass_sum,
                          std::vector<int>& mass_cnt,
                          std::vector<std::vector<double>>* traces,
                          Scratch& s, std::vector<Cell>& queue, int max_cells,
                          int* n_cells) {
    const int ns = m.ns;
    double t = cell.t0;
    double h = 1e-3;
    std::vector<double> y = cell.y;
    std::vector<double> trace;
    if (traces) trace.assign(obs.times.size(), NAN);
    size_t oi = 0;
    while (oi < obs.times.size() && obs.times[oi] < t) oi++;
    int steps = 0;
    while (t < t_end) {
        if (++steps > 200000) return false;
        double hs = std::min(h, t_end - t);
        double errn;
        if (!rodas3_step(m, p, y.data(), hs, rtol, atol, s, &errn))
            return false;
        double fac = 0.9 * std::pow(errn + 1e-30, -1.0 / 3.0);
        fac = fac < 0.2 ? 0.2 : (fac > 6.0 ? 6.0 : fac);
        if (errn <= 1.0) {
            double tnew = t + hs;
            // record mass at observation times inside this step (linear
            // dense output, same role as the stored-interpolant lookup in
            // Cell::GetInterpolatedSpeciesValue)
            while (oi < obs.times.size() && obs.times[oi] <= tnew) {
                double w = (obs.times[oi] - t) / hs;
                double v = (1 - w) * y[0] + w * s.ynew[0];
                mass_sum[oi] += v;
                mass_cnt[oi] += 1;
                if (traces) trace[oi] = v;
                oi++;
            }
            // division event: cytokinesis crosses 1 inside the step
            if (y[1] < 1.0 && s.ynew[1] >= 1.0) {
                double w = (1.0 - y[1]) / (s.ynew[1] - y[1]);
                double tdiv = t + w * hs;
                if (*n_cells + 2 <= max_cells) {
                    Cell c;
                    c.t0 = tdiv;
                    c.y.resize(ns);
                    for (int i = 0; i < ns; i++)
                        c.y[i] = (1 - w) * y[i] + w * s.ynew[i];
                    c.y[0] *= 0.5;  // daughters split the mass
                    c.y[1] = 0.0;   // division clock resets
                    queue.push_back(c);
                    queue.push_back(c);
                    *n_cells += 2;
                }
                if (traces) traces->push_back(std::move(trace));
                return true;  // parent ends at division (Cell.cpp:44-50)
            }
            t = tnew;
            y = s.ynew;
        }
        h = hs * fac;
        if (h < 1e-12) return false;
    }
    if (traces) traces->push_back(std::move(trace));
    return true;
}

static double evaluate(const Model& m, double k_growth, double k_div_mean,
                       double cv_kdiv, double sd, int initial_cells,
                       int max_cells, const Obs& obs, bool matched,
                       Scratch& s, std::mt19937_64& rng) {
    std::normal_distribution<double> nd(0.0, 1.0);
    double t_end = obs.times.back() + 0.5;  // trailing_simulation_time
    std::vector<double> mass_sum(obs.times.size(), 0.0);
    std::vector<int> mass_cnt(obs.times.size(), 0);
    std::vector<std::vector<double>> traces;
    std::vector<Cell> queue;
    int n_cells = initial_cells;
    for (int i = 0; i < initial_cells; i++) {
        Cell c;
        c.t0 = 0.0;
        c.y.assign(m.ns, 0.0);
        c.y[0] = 1.0;
        queue.push_back(c);
    }
    // work queue grows as cells divide (Experiment.cpp:691-779)
    for (size_t qi = 0; qi < queue.size(); qi++) {
        CellParams p;
        p.k_growth = k_growth;
        // per-cell multiplicative-log variability on the division clock
        // (VariabilityDescription; Sobol in the reference, pseudo here —
        // identical arithmetic per draw)
        p.k_div = k_div_mean * std::exp(cv_kdiv * nd(rng));
        if (!simulate_cell(m, p, queue[qi], t_end, 1e-6, 1e-6, obs, mass_sum,
                           mass_cnt, matched ? &traces : nullptr, s, queue,
                           max_cells, &n_cells))
            return -INFINITY;
    }
    const double LSQRT2PI = 0.9189385332046727;
    if (!matched) {
        // population-average time course, normal error model
        double logp = 0.0;
        for (size_t i = 0; i < obs.times.size(); i++) {
            if (!mass_cnt[i]) return -INFINITY;
            double avg = mass_sum[i] / mass_cnt[i];
            double z = (avg - obs.observed[i]) / sd;
            logp += -LSQRT2PI - std::log(sd) - 0.5 * z * z;
        }
        return logp;
    }
    // Hungarian-matched per-cell time-course scoring
    // (DataLikelihoodTimeCourse.cpp:187-355): likelihood matrix over
    // (observed cell, simulated cell), JV LAP for the max-likelihood
    // assignment. Missing simulated points get the reference-style
    // fixed penalty (see bcm3_tpu/cellpop/data_likelihood.py).
    const int n_obs = (int)obs.cells.size();
    const int n_sim = (int)traces.size();
    if (n_sim < n_obs) return -INFINITY;
    const double mst = 3600.0;
    const double penalty = -LSQRT2PI - std::log(mst) - 0.5;  // z=1
    std::vector<double> cost((size_t)n_obs * n_sim);
    for (int i = 0; i < n_obs; i++) {
        for (int j = 0; j < n_sim; j++) {
            double lp = 0.0;
            for (size_t ti = 0; ti < obs.times.size(); ti++) {
                const double yv = obs.cells[i][ti];
                if (std::isnan(yv)) continue;
                const double xv = traces[j][ti];
                if (std::isnan(xv)) {
                    lp += penalty;
                } else {
                    double z = (yv - xv) / sd;
                    lp += -LSQRT2PI - std::log(sd) - 0.5 * z * z;
                }
            }
            // LAP minimises; negate the log-likelihood
            cost[(size_t)i * n_sim + j] = -lp;
        }
    }
    std::vector<int> assign(n_obs);
    double neg_total = bcm3_lap_solve(n_obs, n_sim, cost.data(), assign.data());
    if (!std::isfinite(neg_total)) return -INFINITY;
    return -neg_total;
}

int main(int argc, char** argv) {
    if (argc < 3) {
        std::fprintf(stderr,
                     "usage: %s n_evals n_threads [max_cells] [initial] "
                     "[modules] [matched]\n",
                     argv[0]);
        return 1;
    }
    int n_evals = std::atoi(argv[1]);
    int n_threads = std::atoi(argv[2]);
    int max_cells = argc > 3 ? std::atoi(argv[3]) : 128;
    int initial_cells = argc > 4 ? std::atoi(argv[4]) : 16;
    int modules = argc > 5 ? std::atoi(argv[5]) : 0;
    bool matched = argc > 6 && std::atoi(argv[6]) != 0;

    Model model;
    model.modules = modules;
    model.ns = 4 + 2 * modules;

    // same synthetic data as tools/bench_cellpop_scaling.py
    Obs obs;
    double k_growth_true = 0.1;
    for (int i = 0; i < 12; i++) {
        double t = 0.5 + (10.0 - 0.5) * i / 11.0;
        obs.times.push_back(t);
        obs.observed.push_back(std::exp(k_growth_true * 0.6 * t));
    }
    if (matched) {
        // per-cell observed traces with lognormal spread (same law as
        // bench_cellpop_scaling.py build_likelihood matched=True)
        std::mt19937_64 orng(3);
        std::normal_distribution<double> nd(0.0, 0.15);
        for (int c = 0; c < initial_cells; c++) {
            std::vector<double> row(obs.times.size());
            double f = std::exp(nd(orng));
            for (size_t ti = 0; ti < obs.times.size(); ti++)
                row[ti] = obs.observed[ti] * f;
            obs.cells.push_back(std::move(row));
        }
    }

    std::atomic<long> done(0);
    std::atomic<long> finite(0);
    double sink = 0.0;
    auto worker = [&](int tid) {
        std::mt19937_64 rng(99 + tid);
        std::uniform_real_distribution<double> u(-0.5, 0.5);
        Scratch s;
        s.init(model.ns);
        double local = 0.0;
        while (done.fetch_add(1) < n_evals) {
            // fresh parameter draw each eval (like a proposal)
            double kg = 0.1 * std::exp(0.05 * u(rng));
            double kd = 0.25 * std::exp(0.05 * u(rng));
            double cv = 0.15 * std::exp(0.05 * u(rng));
            double sd = 0.05 * std::exp(0.05 * u(rng));
            double lp = evaluate(model, kg, kd, cv, sd, initial_cells,
                                 max_cells, obs, matched, s, rng);
            if (std::isfinite(lp)) finite.fetch_add(1);
            local += std::isfinite(lp) ? lp : 0.0;
        }
        sink += local;
    };

    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> threads;
    for (int i = 0; i < n_threads; i++) threads.emplace_back(worker, i);
    for (auto& th : threads) th.join();
    double el =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count();
    std::printf(
        "{\"cellpop_evals_per_sec\": %.2f, \"elapsed\": %.3f, \"finite\": "
        "%ld, \"max_cells\": %d, \"initial_cells\": %d, \"species\": %d, "
        "\"matched\": %d, \"threads\": %d, \"sink\": %g}\n",
        n_evals / el, el, (long)finite.load(), max_cells, initial_cells,
        model.ns + 1 /* + constant env, the Python bench's species count */,
        matched ? 1 : 0, n_threads, sink);
    return 0;
}
