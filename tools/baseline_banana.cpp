// CPU baseline for the reference BCM3 sampler ENGINE on the banana target.
//
// The PopPK/cellpop anchors (baseline_surrogate.cpp, baseline_cellpop.cpp)
// measure the batched-ODE advantage; this tool isolates the sampler engine
// itself: the reference's parallel-tempered MH loop with the adaptive
// Gaussian-mixture proposal, on the analytic 2-D banana example it ships
// (examples/banana/config.txt: 6 chains, thin 5, GMM proposal, one
// adaptation at 2000 emitted samples). The reference cannot be built in
// this image (Boost absent), so the algorithms are re-implemented from
// its sources:
//   - banana log-density               TestLikelihoodBanana.cpp:42-55
//   - power-law ladder, T=0 chain      SamplerPT.cpp:87-93
//   - deterministic even/odd exchange  SamplerPT.cpp:277-306,
//                                      SamplerPTChain.cpp:328-381
//   - mutate + power-posterior accept  SamplerPTChain.cpp:217-313
//   - GMM proposal, mixture MH ratio,  ProposalGaussianMixture.cpp:18-99
//     per-component scale EMA
//   - GMM fit: k-means++ EM over       GMM.cpp:48-338
//     k in {1,2,3,4,5,8,13}, best AIC
//   - history ring buffer (float32)    SampleHistory.cpp:18-86
//
// Threading: the reference fans the 6 chains of one ladder over its
// TaskManager threads, paying a condvar join per iteration. To avoid
// modeling that overhead (which would weaken the baseline), each thread
// here runs an INDEPENDENT full PT ladder with zero synchronization —
// a strictly stronger CPU baseline than the reference achieves.
//
// pooled=1 runs the ladders of a run instead as the JAX engine's
// ensembles (PTConfig.num_ensembles): in lockstep on one thread, and at the
// adaptation boundary one GMM per temperature is fitted to the history of
// all ladders pooled and shared by them. As in the reference
// (SamplerPT.cpp:115-128, Proposal.cpp:86-129) the history then keeps
// every 4th add, so that the 5000 rows span the run up to the boundary,
// and the pooled rows are downsampled to 2000 (stride, then random
// discard) before the fit. Runs of different seeds go on parallel threads.
//
// Output: one JSON line with banana_ess_per_sec = mean-per-variable ESS
// of the emitted T=1 samples' post-burn-in half, summed over threads,
// divided by wall time. ESS uses the same initial-positive-sequence
// autocorrelation truncation as bcm3_tpu/analysis.py (and R/stats.r's
// ess statistic), so the ratio against bench.py's banana_ess_per_sec is
// apples-to-apples.
//
// Each run also reports the T=1 means and standard deviations of the
// samples emitted after the adaptation boundary, pooled over its ladders.
// With num_seeds > 1 the tool repeats the run with num_seeds seeds and ends
// with one summary line: the mean over seeds and the between-seed sd of
// each statistic, the run-level Monte Carlo error of a run of this size.
// freeze_scales=1 stops the per-component scale updates at the adaptation
// boundary, so the chains after it are plain MH with a fixed proposal.
//
// Usage: baseline_banana [num_samples=8000] [num_threads=2] [seed=1234]
//                        [num_seeds=1] [freeze_scales=0] [pooled=0]
// num_threads is the number of ladders of one run.

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <random>
#include <thread>
#include <vector>

static const int D = 2;
static const int NCHAINS = 6;
static const int THIN = 5;  // use_every_nth
static const double SD1 = 2.0, SD2 = 1.0;
static const double LO[D] = {-6.0, -6.0};
static const double HI[D] = {4.0, 20.0};
static const double TARGET_ACC = 0.35;  // d=2 (Proposal.cpp:47-55)
static const double SCALING_LEARNING_RATE = 0.05;   // Proposal.cpp:26
static const double SCALING_EMA_PERIOD = 1000.0;    // Proposal.cpp:25
static const int MAX_HISTORY = 5000;  // banana config max_history_size
static const int ADAPT_AT_SAMPLES = 2000;  // adapt_proposal_samples
// pooled mode: adds per emitted sample = THIN iterations x (exchange +
// mutate); history subsampling ceil(expected / MAX_HISTORY)
// (SamplerPT.cpp:115-128)
static const int POOLED_HIST_SUB =
    (ADAPT_AT_SAMPLES * THIN * 2 + MAX_HISTORY - 1) / MAX_HISTORY;
static const int MAX_HISTORY_SAMPLES = 2000;  // adapt_proposal_max_history_samples

static const double LOG2PI = 1.8378770664093453;

static inline double logsum(double la, double lb) {
    if (la == -std::numeric_limits<double>::infinity()) return lb;
    if (lb == -std::numeric_limits<double>::infinity()) return la;
    double m = std::max(la, lb);
    return m + std::log(std::exp(la - m) + std::exp(lb - m));
}

static inline double log_pdf_normal(double x, double mu, double sd) {
    double z = (x - mu) / sd;
    return -0.5 * z * z - std::log(sd) - 0.5 * LOG2PI;
}

// banana log-likelihood (TestLikelihoodBanana.cpp:42-55, dim=2)
static inline double banana_llh(const double* v) {
    double y = v[0];
    return log_pdf_normal(v[0], 0.0, SD1) +
           log_pdf_normal(v[1], y + 3 * y + (1 - y) * (1 - y), SD2);
}

static inline double banana_lprior(const double* v) {
    for (int i = 0; i < D; i++)
        if (v[i] < LO[i] || v[i] > HI[i])
            return -std::numeric_limits<double>::infinity();
    return -std::log((HI[0] - LO[0]) * (HI[1] - LO[1]));
}

// reflect-on-bounds (Proposal.cpp:385-397)
static inline double reflect(double x, double lo, double hi) {
    for (int it = 0; it < 64 && (x < lo || x > hi); it++) {
        if (x < lo) x = lo + (lo - x);
        if (x > hi) x = hi - (x - hi);
    }
    return std::min(std::max(x, lo), hi);
}

// ---- 2x2 symmetric matrix helpers -----------------------------------------
struct Chol2 {
    double l00, l10, l11;  // lower Cholesky factor
    bool ok;
};
static Chol2 chol2(const double c[3]) {  // c = {c00, c01, c11}
    Chol2 r;
    r.ok = false;
    if (c[0] <= 0) return r;
    r.l00 = std::sqrt(c[0]);
    r.l10 = c[1] / r.l00;
    double t = c[2] - r.l10 * r.l10;
    if (t <= 0) return r;
    r.l11 = std::sqrt(t);
    r.ok = true;
    return r;
}
static inline void chol_solve(const Chol2& L, const double v[2], double s[2]) {
    s[0] = v[0] / L.l00;
    s[1] = (v[1] - L.l10 * s[0]) / L.l11;
}

// ---- GMM -------------------------------------------------------------------
struct GMM {
    int k = 1;
    std::vector<double> w;       // k
    std::vector<double> mean;    // k*2
    std::vector<double> cov;     // k*3 (c00, c01, c11)
    std::vector<Chol2> L;        // k
    std::vector<double> logC;    // k: -0.5*(d log 2pi + log det)
    void finalize() {
        L.resize(k);
        logC.resize(k);
        for (int c = 0; c < k; c++) {
            L[c] = chol2(&cov[3 * c]);
            double logdet = 2.0 * std::log(L[c].l00 * L[c].l11);
            logC[c] = -0.5 * (D * LOG2PI + logdet);
        }
    }
    double comp_logpdf(int c, const double* x) const {
        double v[2] = {x[0] - mean[2 * c], x[1] - mean[2 * c + 1]};
        double s[2];
        chol_solve(L[c], v, s);
        return logC[c] - 0.5 * (s[0] * s[0] + s[1] * s[1]);
    }
    // responsibilities (GMM::CalculateResponsibilities, GMM.cpp:346)
    void responsibilities(const double* x, double* resp) const {
        double lp[16], mx = -std::numeric_limits<double>::infinity();
        for (int c = 0; c < k; c++) {
            lp[c] = std::log(w[c]) + comp_logpdf(c, x);
            mx = std::max(mx, lp[c]);
        }
        double tot = 0;
        for (int c = 0; c < k; c++) {
            resp[c] = std::exp(lp[c] - mx);
            tot += resp[c];
        }
        for (int c = 0; c < k; c++) resp[c] /= tot;
    }
};

// k-means++ seeded EM fit, best-AIC over the reference's component grid
// (GMM.cpp:48-338; ProposalGaussianMixture AIC selection :129-187)
static bool fit_gmm_em(const std::vector<float>& hist, int n, int k,
                       std::mt19937_64& rng, GMM& out, double& aic) {
    if (n < 2 * k) return false;
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    // k-means++ init
    std::vector<double> centers(2 * k);
    int first = (int)(unif(rng) * n);
    centers[0] = hist[2 * first];
    centers[1] = hist[2 * first + 1];
    std::vector<double> d2(n);
    for (int c = 1; c < k; c++) {
        double tot = 0;
        for (int i = 0; i < n; i++) {
            double best = std::numeric_limits<double>::infinity();
            for (int j = 0; j < c; j++) {
                double dx = hist[2 * i] - centers[2 * j];
                double dy = hist[2 * i + 1] - centers[2 * j + 1];
                best = std::min(best, dx * dx + dy * dy);
            }
            d2[i] = best;
            tot += best;
        }
        double r = unif(rng) * tot, acc = 0;
        int pick = n - 1;
        for (int i = 0; i < n; i++) {
            acc += d2[i];
            if (acc >= r) { pick = i; break; }
        }
        centers[2 * c] = hist[2 * pick];
        centers[2 * c + 1] = hist[2 * pick + 1];
    }
    GMM g;
    g.k = k;
    g.w.assign(k, 1.0 / k);
    g.mean = centers;
    g.cov.assign(3 * k, 0.0);
    // init covariances from hard assignment
    {
        std::vector<int> assign(n);
        std::vector<int> cnt(k, 0);
        for (int i = 0; i < n; i++) {
            double best = std::numeric_limits<double>::infinity();
            int bi = 0;
            for (int j = 0; j < k; j++) {
                double dx = hist[2 * i] - g.mean[2 * j];
                double dy = hist[2 * i + 1] - g.mean[2 * j + 1];
                double dd = dx * dx + dy * dy;
                if (dd < best) { best = dd; bi = j; }
            }
            assign[i] = bi;
            cnt[bi]++;
        }
        for (int i = 0; i < n; i++) {
            int c = assign[i];
            double dx = hist[2 * i] - g.mean[2 * c];
            double dy = hist[2 * i + 1] - g.mean[2 * c + 1];
            g.cov[3 * c] += dx * dx;
            g.cov[3 * c + 1] += dx * dy;
            g.cov[3 * c + 2] += dy * dy;
        }
        for (int c = 0; c < k; c++) {
            if (cnt[c] < 2) return false;
            for (int j = 0; j < 3; j++) g.cov[3 * c + j] /= cnt[c];
            g.cov[3 * c] += 1e-8;
            g.cov[3 * c + 2] += 1e-8;
        }
    }
    // EM
    std::vector<double> resp(n * k);
    double prev_ll = -std::numeric_limits<double>::infinity(), ll = 0;
    for (int it = 0; it < 100; it++) {
        g.finalize();
        for (int c = 0; c < k; c++)
            if (!g.L[c].ok) return false;
        ll = 0;
        for (int i = 0; i < n; i++) {
            double x[2] = {hist[2 * i], hist[2 * i + 1]};
            double mx = -std::numeric_limits<double>::infinity();
            double lp[16];
            for (int c = 0; c < k; c++) {
                lp[c] = std::log(g.w[c]) + g.comp_logpdf(c, x);
                mx = std::max(mx, lp[c]);
            }
            double tot = 0;
            for (int c = 0; c < k; c++) {
                resp[i * k + c] = std::exp(lp[c] - mx);
                tot += resp[i * k + c];
            }
            for (int c = 0; c < k; c++) resp[i * k + c] /= tot;
            ll += mx + std::log(tot);
        }
        if (std::fabs(ll - prev_ll) < 1e-6 * std::fabs(ll)) break;
        prev_ll = ll;
        // M step
        for (int c = 0; c < k; c++) {
            double nk = 0, mx_ = 0, my = 0;
            for (int i = 0; i < n; i++) {
                nk += resp[i * k + c];
                mx_ += resp[i * k + c] * hist[2 * i];
                my += resp[i * k + c] * hist[2 * i + 1];
            }
            if (nk < 1e-6) return false;
            g.w[c] = nk / n;
            g.mean[2 * c] = mx_ / nk;
            g.mean[2 * c + 1] = my / nk;
            double c00 = 0, c01 = 0, c11 = 0;
            for (int i = 0; i < n; i++) {
                double dx = hist[2 * i] - g.mean[2 * c];
                double dy = hist[2 * i + 1] - g.mean[2 * c + 1];
                c00 += resp[i * k + c] * dx * dx;
                c01 += resp[i * k + c] * dx * dy;
                c11 += resp[i * k + c] * dy * dy;
            }
            g.cov[3 * c] = c00 / nk + 1e-8;
            g.cov[3 * c + 1] = c01 / nk;
            g.cov[3 * c + 2] = c11 / nk + 1e-8;
        }
    }
    g.finalize();
    for (int c = 0; c < k; c++)
        if (!g.L[c].ok) return false;
    int nparams = k * (D + D * (D + 1) / 2) + (k - 1);
    aic = 2.0 * nparams - 2.0 * ll;
    out = g;
    return true;
}

static GMM fit_best_aic(const std::vector<float>& hist, int n,
                        std::mt19937_64& rng, const GMM& fallback) {
    static const int KS[] = {1, 2, 3, 4, 5, 8, 13};
    GMM best = fallback;
    double best_aic = std::numeric_limits<double>::infinity();
    bool any = false;
    for (int ki = 0; ki < 7; ki++) {
        GMM g;
        double aic;
        if (fit_gmm_em(hist, n, KS[ki], rng, g, aic)) {
            if (!any || aic < best_aic) {
                best = g;
                best_aic = aic;
                any = true;
            }
        }
    }
    return best;
}

// ---- PT chain --------------------------------------------------------------
struct Chain {
    double temperature;
    double x[D];
    double lprior, llh, lpp;
    GMM gmm;
    std::vector<double> scales;    // per component
    std::vector<double> acc_ema;   // per component
    int selected_component = -1;
    // float32 history ring buffer (SampleHistory.cpp:41)
    std::vector<float> history;
    int hist_pos = 0, hist_n = 0;
    int hist_sub = 1;  // keep every hist_sub-th add
    long hist_adds = 0;
    long attempted = 0, accepted = 0;
    // exchange acceptance, attributed to the pair leader (the lower
    // ladder index), matching the JAX engine's bookkeeping and the
    // reference's per-temperature exchange statistics
    // (SamplerPTChain.cpp:383-389)
    long att_exc = 0, acc_exc = 0;

    void add_history() {
        if (temperature == 0.0) return;
        if (++hist_adds % hist_sub != 0) return;
        if ((int)history.size() < 2 * MAX_HISTORY)
            history.resize(2 * MAX_HISTORY);
        history[2 * hist_pos] = (float)x[0];
        history[2 * hist_pos + 1] = (float)x[1];
        hist_pos = (hist_pos + 1) % MAX_HISTORY;
        hist_n = std::min(hist_n + 1, MAX_HISTORY);
    }
    double lpowerposterior() const {
        if (temperature == 0.0) return lprior;  // SamplerPTChain.cpp:231-237
        return lprior + temperature * llh;
    }
};

struct LadderResult {
    std::vector<double> emitted;  // S*2 T=1 samples
    long evals = 0;
    // per-ladder-position acceptance counters (index = ladder position)
    long att_mut[NCHAINS] = {0}, acc_mut[NCHAINS] = {0};
    long att_exc[NCHAINS] = {0}, acc_exc[NCHAINS] = {0};
};

// subsample-then-random-discard of n pooled rows to at most
// MAX_HISTORY_SAMPLES (Proposal.cpp:86-129)
static std::vector<int> downsample(int n, std::mt19937_64& rng) {
    std::vector<int> ix;
    if (n <= MAX_HISTORY_SAMPLES) {
        for (int i = 0; i < n; i++) ix.push_back(i);
        return ix;
    }
    int stride = n / MAX_HISTORY_SAMPLES;
    int m = stride > 1 ? n / stride : n;
    for (int i = 0; i < m; i++) ix.push_back(i * std::max(stride, 1));
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    while ((int)ix.size() > MAX_HISTORY_SAMPLES)
        ix.erase(ix.begin() + (int)(unif(rng) * ix.size()));
    return ix;
}

// num_ladders ladders on one thread in lockstep from one RNG stream; with
// one ladder and pooled=false, the reference's single ladder
static void run_group(int num_samples, int num_ladders, bool pooled,
                      unsigned seed, bool freeze_scales,
                      LadderResult* outs) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    std::normal_distribution<double> gauss(0.0, 1.0);

    std::vector<std::array<Chain, NCHAINS>> ladders(num_ladders);
    GMM fallback;  // prior-variance diagonal Gaussian
    fallback.k = 1;
    fallback.w = {1.0};
    fallback.mean = {0.5 * (LO[0] + HI[0]), 0.5 * (LO[1] + HI[1])};
    double v0 = (HI[0] - LO[0]) * (HI[0] - LO[0]) / 12.0;
    double v1 = (HI[1] - LO[1]) * (HI[1] - LO[1]) / 12.0;
    fallback.cov = {v0, 0.0, v1};
    fallback.finalize();

    for (int e = 0; e < num_ladders; e++) {
        for (int c = 0; c < NCHAINS; c++) {
            Chain& ch = ladders[e][c];
            double frac = (double)c / (NCHAINS - 1);
            ch.temperature = frac * frac * frac;  // power 3 ladder
            ch.gmm = fallback;
            ch.scales.assign(1, 2.38 / std::sqrt((double)D));
            ch.acc_ema.assign(1, TARGET_ACC);
            ch.hist_sub = pooled ? POOLED_HIST_SUB : 1;
            // find starting position: prior draws (always finite here)
            for (int i = 0; i < D; i++)
                ch.x[i] = LO[i] + unif(rng) * (HI[i] - LO[i]);
            ch.lprior = banana_lprior(ch.x);
            ch.llh = banana_llh(ch.x);
            outs[e].evals++;
            ch.lpp = ch.lpowerposterior();
        }
    }

    bool previous_swap_even = false;
    long total_iters = (long)num_samples * THIN;
    int emitted = 0;
    bool adapted = false;

    for (long si = 0; si < total_iters; si++) {
        // deterministic even/odd exchange each iteration
        int start_ix = previous_swap_even ? 1 : 0;
        previous_swap_even = !previous_swap_even;
        for (int e = 0; e < num_ladders; e++) {
            Chain* chains = ladders[e].data();
            LadderResult* out = &outs[e];
            for (int ci = start_ix; ci < NCHAINS; ci += 2) {
                Chain& c1 = chains[ci];
                Chain& c2 = chains[(ci + 1) % NCHAINS];
                double p1 = (c1.temperature == 0.0)
                                ? c2.lprior
                                : c1.temperature * c2.llh + c2.lprior;
                double p2 = (c2.temperature == 0.0)
                                ? c1.lprior
                                : c2.temperature * c1.llh + c1.lprior;
                double tp = std::exp((p1 + p2) - (c1.lpp + c2.lpp));
                c1.att_exc++;
                if (unif(rng) < std::min(1.0, tp)) {
                    c1.acc_exc++;
                    std::swap(c1.x[0], c2.x[0]);
                    std::swap(c1.x[1], c2.x[1]);
                    std::swap(c1.llh, c2.llh);
                    std::swap(c1.lprior, c2.lprior);
                    c1.lpp = p1;
                    c2.lpp = p2;
                }
                c1.add_history();
                c2.add_history();
            }

            // mutate every chain (1 exploration step)
            for (int ci = 0; ci < NCHAINS; ci++) {
                Chain& ch = chains[ci];
                ch.attempted++;
                if (ch.temperature == 0.0) {
                    // prior chain samples the prior directly
                    for (int i = 0; i < D; i++)
                        ch.x[i] = LO[i] + unif(rng) * (HI[i] - LO[i]);
                    ch.lprior = banana_lprior(ch.x);
                    ch.llh = banana_llh(ch.x);
                    out->evals++;
                    ch.lpp = ch.lpowerposterior();
                    ch.accepted++;
                    continue;
                }
                // scale update for the previously selected component
                // (ProposalGaussianMixture::Update)
                if (ch.selected_component >= 0 && !(freeze_scales && adapted)) {
                    int sc = ch.selected_component;
                    double lr = 1.0 + unif(rng) * SCALING_LEARNING_RATE * ch.gmm.k;
                    if (ch.acc_ema[sc] <
                        TARGET_ACC / (1.0 - SCALING_LEARNING_RATE)) {
                        ch.scales[sc] = std::max(ch.scales[sc] / lr, 1e-4);
                    } else if (ch.acc_ema[sc] >
                               (1.0 + SCALING_LEARNING_RATE) * TARGET_ACC) {
                        ch.scales[sc] = std::min(ch.scales[sc] * lr, 10.0);
                    }
                }
                // propose from responsibility-weighted component
                double resp[16];
                ch.gmm.responsibilities(ch.x, resp);
                double r = unif(rng), acc = 0;
                int comp = ch.gmm.k - 1;
                for (int c = 0; c < ch.gmm.k; c++) {
                    acc += resp[c];
                    if (r <= acc) { comp = c; break; }
                }
                ch.selected_component = comp;
                double z[2] = {gauss(rng), gauss(rng)};
                const Chol2& L = ch.gmm.L[comp];
                double step[2] = {L.l00 * z[0], L.l10 * z[0] + L.l11 * z[1]};
                double xp[2];
                for (int i = 0; i < D; i++)
                    xp[i] = reflect(ch.x[i] + ch.scales[comp] * step[i], LO[i],
                                    HI[i]);
                // mixture MH correction (ProposalGaussianMixture:44-63)
                double rev[16];
                ch.gmm.responsibilities(xp, rev);
                double fwd_lp = -std::numeric_limits<double>::infinity();
                double rev_lp = -std::numeric_limits<double>::infinity();
                double dvec[2] = {xp[0] - ch.x[0], xp[1] - ch.x[1]};
                for (int c = 0; c < ch.gmm.k; c++) {
                    double v[2] = {dvec[0] / ch.scales[c], dvec[1] / ch.scales[c]};
                    double s[2];
                    chol_solve(ch.gmm.L[c], v, s);
                    double q = -std::log(ch.scales[c] * ch.scales[c]) +
                               ch.gmm.logC[c] - 0.5 * (s[0] * s[0] + s[1] * s[1]);
                    fwd_lp = logsum(fwd_lp, q + std::log(resp[c]));
                    v[0] = -v[0];
                    v[1] = -v[1];
                    chol_solve(ch.gmm.L[c], v, s);
                    rev_lp = logsum(rev_lp, q + std::log(rev[c]));
                }
                double lprior_p = banana_lprior(xp);
                double llh_p = banana_llh(xp);
                out->evals++;
                double lpp_p = (lprior_p ==
                                -std::numeric_limits<double>::infinity())
                                   ? lprior_p
                                   : lprior_p + ch.temperature * llh_p;
                double log_alpha = (lpp_p - ch.lpp) + (rev_lp - fwd_lp);
                bool accept = std::log(unif(rng)) < log_alpha;
                double ema_alpha = 2.0 / (SCALING_EMA_PERIOD + 1.0);
                ch.acc_ema[comp] += ((accept ? 1.0 : 0.0) - ch.acc_ema[comp]) *
                                    ema_alpha;
                if (accept) {
                    ch.x[0] = xp[0];
                    ch.x[1] = xp[1];
                    ch.lprior = lprior_p;
                    ch.llh = llh_p;
                    ch.lpp = lpp_p;
                    ch.accepted++;
                }
                ch.add_history();
            }
        }

        if ((si + 1) % THIN == 0) {
            for (int e = 0; e < num_ladders; e++) {
                outs[e].emitted.push_back(ladders[e][NCHAINS - 1].x[0]);
                outs[e].emitted.push_back(ladders[e][NCHAINS - 1].x[1]);
            }
            emitted++;
            if (!adapted && emitted == ADAPT_AT_SAMPLES &&
                si + 1 != total_iters) {
                for (int ci = 0; ci < NCHAINS; ci++) {
                    if (ladders[0][ci].temperature == 0.0) continue;
                    if (pooled) {
                        // one fit to the downsampled history of every
                        // ladder at this temperature, ladder-major
                        std::vector<float> rows;
                        for (int e = 0; e < num_ladders; e++) {
                            const Chain& ch = ladders[e][ci];
                            rows.insert(rows.end(), ch.history.begin(),
                                        ch.history.begin() + 2 * ch.hist_n);
                        }
                        int n = (int)(rows.size() / 2);
                        std::vector<int> ix = downsample(n, rng);
                        std::vector<float> h;
                        for (int i : ix) {
                            h.push_back(rows[2 * i]);
                            h.push_back(rows[2 * i + 1]);
                        }
                        GMM g = (int)ix.size() < 20
                                    ? fallback
                                    : fit_best_aic(h, (int)ix.size(), rng,
                                                   fallback);
                        for (int e = 0; e < num_ladders; e++)
                            ladders[e][ci].gmm = g;
                    }
                    for (int e = 0; e < num_ladders; e++) {
                        Chain& ch = ladders[e][ci];
                        if (!pooled) {
                            if (ch.hist_n < 20) continue;
                            ch.gmm = fit_best_aic(ch.history, ch.hist_n, rng,
                                                  fallback);
                        }
                        ch.scales.assign(ch.gmm.k, 2.38 / std::sqrt((double)D));
                        ch.acc_ema.assign(ch.gmm.k, TARGET_ACC);
                        ch.selected_component = -1;
                        ch.hist_n = 0;  // history reset after adaptation
                        ch.hist_pos = 0;
                    }
                }
                adapted = true;
            }
        }
    }
    for (int e = 0; e < num_ladders; e++) {
        for (int ci = 0; ci < NCHAINS; ci++) {
            outs[e].att_mut[ci] = ladders[e][ci].attempted;
            outs[e].acc_mut[ci] = ladders[e][ci].accepted;
            outs[e].att_exc[ci] = ladders[e][ci].att_exc;
            outs[e].acc_exc[ci] = ladders[e][ci].acc_exc;
        }
    }
}

// initial-positive-sequence ESS, identical convention to
// bcm3_tpu/analysis.py effective_sample_size
static double ess(const std::vector<double>& x) {
    int n = (int)x.size();
    if (n < 3) return n;
    double mean = 0;
    for (double v : x) mean += v;
    mean /= n;
    double var = 0;
    for (double v : x) var += (v - mean) * (v - mean);
    var /= (n - 1);
    if (var <= 0) return n;
    double s = 0;
    for (int lag = 1; lag < n; lag++) {
        double acov = 0;
        for (int i = 0; i + lag < n; i++)
            acov += (x[i] - mean) * (x[i + lag] - mean);
        double rho = acov / (n - lag) / var;
        if (rho < 0) break;
        s += rho;
    }
    double e = n / (1.0 + 2.0 * s);
    return std::min(std::max(e, 1.0), (double)n);
}

struct RunResult {
    double elapsed, total_ess, mean[D], sd[D];
    long total_evals;
    double mut_rate[NCHAINS], exc_rate[NCHAINS];
};

static RunResult run(int num_samples, int num_threads, unsigned seed,
                     bool freeze_scales, bool pooled) {
    std::vector<LadderResult> results(num_threads);
    auto t0 = std::chrono::steady_clock::now();
    if (pooled) {
        run_group(num_samples, num_threads, true, seed, freeze_scales,
                  results.data());
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < num_threads; t++)
            threads.emplace_back(run_group, num_samples, 1, false,
                                 seed + 7919u * t, freeze_scales, &results[t]);
        for (auto& th : threads) th.join();
    }
    RunResult rr;
    rr.elapsed =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count();

    // ESS per thread over the post-burn-in half, mean over variables
    rr.total_ess = 0;
    rr.total_evals = 0;
    for (auto& r : results) {
        int S = (int)(r.emitted.size() / 2);
        std::vector<double> col(S - S / 2);
        double ess_mean = 0;
        for (int v = 0; v < D; v++) {
            for (int i = S / 2; i < S; i++) col[i - S / 2] = r.emitted[2 * i + v];
            ess_mean += ess(col);
        }
        rr.total_ess += ess_mean / D;
        rr.total_evals += r.evals;
    }
    // T=1 moments of the samples emitted after the adaptation boundary,
    // pooled over ladders
    for (int v = 0; v < D; v++) {
        double s1 = 0, s2 = 0;
        long n = 0;
        for (auto& r : results) {
            int S = (int)(r.emitted.size() / 2);
            for (int i = std::min(ADAPT_AT_SAMPLES, S); i < S; i++) {
                s1 += r.emitted[2 * i + v];
                n++;
            }
        }
        rr.mean[v] = n ? s1 / n : 0.0;
        for (auto& r : results) {
            int S = (int)(r.emitted.size() / 2);
            for (int i = std::min(ADAPT_AT_SAMPLES, S); i < S; i++) {
                double d = r.emitted[2 * i + v] - rr.mean[v];
                s2 += d * d;
            }
        }
        rr.sd[v] = n ? std::sqrt(s2 / n) : 0.0;
    }
    // per-temperature acceptance rates pooled over ladders — the parity
    // artifact against the JAX engine's identical bookkeeping
    // (reference logging: SamplerPTChain.cpp:383-389)
    for (int ci = 0; ci < NCHAINS; ci++) {
        long am = 0, cm = 0, ae = 0, ce = 0;
        for (auto& r : results) {
            am += r.att_mut[ci];
            cm += r.acc_mut[ci];
            ae += r.att_exc[ci];
            ce += r.acc_exc[ci];
        }
        rr.mut_rate[ci] = am ? (double)cm / am : 0.0;
        rr.exc_rate[ci] = ae ? (double)ce / ae : 0.0;
    }
    return rr;
}

static void print_array(const char* key, const double* v, int n,
                        const char* fmt = "%.6f") {
    printf(", \"%s\": [", key);
    for (int i = 0; i < n; i++) {
        if (i) printf(", ");
        printf(fmt, v[i]);
    }
    printf("]");
}

int main(int argc, char** argv) {
    int num_samples = argc > 1 ? atoi(argv[1]) : 8000;
    int num_threads = argc > 2 ? atoi(argv[2]) : 2;
    unsigned seed = argc > 3 ? (unsigned)atol(argv[3]) : 1234u;
    int num_seeds = argc > 4 ? atoi(argv[4]) : 1;
    bool freeze_scales = argc > 5 && atoi(argv[5]) != 0;
    bool pooled = argc > 6 && atoi(argv[6]) != 0;

    double temps[NCHAINS];
    for (int ci = 0; ci < NCHAINS; ci++) {
        double frac = (double)ci / (NCHAINS - 1);
        temps[ci] = frac * frac * frac;
    }
    // per-seed statistics, in the order: mean, sd, mutate, exchange
    const int NSTAT = 2 * D + 2 * NCHAINS;
    std::vector<std::vector<double>> stats;
    std::vector<RunResult> runs(num_seeds);
    auto run_seed = [&](int s) { return seed + 104729u * (unsigned)s; };
    if (pooled) {  // a run is one thread: runs of different seeds in parallel
        int width = std::max(1u, std::thread::hardware_concurrency());
        for (int s0 = 0; s0 < num_seeds; s0 += width) {
            std::vector<std::thread> threads;
            for (int s = s0; s < std::min(num_seeds, s0 + width); s++)
                threads.emplace_back([&, s] {
                    runs[s] = run(num_samples, num_threads, run_seed(s),
                                  freeze_scales, true);
                });
            for (auto& th : threads) th.join();
        }
    } else {
        for (int s = 0; s < num_seeds; s++)
            runs[s] = run(num_samples, num_threads, run_seed(s), freeze_scales,
                          false);
    }
    for (int s = 0; s < num_seeds; s++) {
        const RunResult& rr = runs[s];
        printf(
            "{\"banana_ess_per_sec\": %.3f, \"ess_mean_per_ladder\": %.2f, "
            "\"evals_per_sec\": %.1f, \"elapsed_s\": %.2f, \"threads\": %d, "
            "\"num_samples\": %d, \"seed\": %u, \"freeze_scales\": %d, "
            "\"pooled\": %d",
            rr.total_ess / rr.elapsed, rr.total_ess / num_threads,
            rr.total_evals / rr.elapsed, rr.elapsed, num_threads, num_samples,
            run_seed(s), (int)freeze_scales, (int)pooled);
        print_array("temperatures", temps, NCHAINS);
        print_array("mutate_rate", rr.mut_rate, NCHAINS, "%.4f");
        print_array("exchange_rate", rr.exc_rate, NCHAINS, "%.4f");
        print_array("mean", rr.mean, D);
        print_array("sd", rr.sd, D);
        printf("}\n");
        fflush(stdout);
        std::vector<double> row(rr.mean, rr.mean + D);
        row.insert(row.end(), rr.sd, rr.sd + D);
        row.insert(row.end(), rr.mut_rate, rr.mut_rate + NCHAINS);
        row.insert(row.end(), rr.exc_rate, rr.exc_rate + NCHAINS);
        stats.push_back(row);
    }
    if (num_seeds > 1) {
        std::vector<double> m(NSTAT, 0.0), sdv(NSTAT, 0.0);
        for (auto& row : stats)
            for (int j = 0; j < NSTAT; j++) m[j] += row[j] / num_seeds;
        for (auto& row : stats)
            for (int j = 0; j < NSTAT; j++)
                sdv[j] += (row[j] - m[j]) * (row[j] - m[j]) / (num_seeds - 1);
        for (int j = 0; j < NSTAT; j++) sdv[j] = std::sqrt(sdv[j]);
        printf("{\"seeds\": %d, \"ladders\": %d, \"num_samples\": %d, "
               "\"freeze_scales\": %d, \"pooled\": %d",
               num_seeds, num_threads, num_samples, (int)freeze_scales,
               (int)pooled);
        const char* names[4] = {"mean", "sd", "mutate_rate", "exchange_rate"};
        const int offs[4] = {0, D, 2 * D, 2 * D + NCHAINS};
        const int lens[4] = {D, D, NCHAINS, NCHAINS};
        char key[64];
        for (int k = 0; k < 4; k++) {
            print_array(names[k], &m[offs[k]], lens[k], "%.8f");
            snprintf(key, sizeof key, "%s_between_seed_sd", names[k]);
            print_array(key, &sdv[offs[k]], lens[k], "%.8f");
        }
        printf("}\n");
    }
    return 0;
}
