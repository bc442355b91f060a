// roe_classifier.cpp — native RoE rain classifier shared library.
//
// The port's own copy of audio_processing_tools_tpu/native/roe_classifier.cpp:
// a rebuild of the reference's closed-source libdsp_shared_lib (a Mach-O C
// dylib shipped in the wheel) with the same exported ABI
//
//   int  sample_classifier_to_evaluate_impl(evmgr_data_input_t*,
//                                           rain_cl_optional_data_t*,
//                                           rain_cl_config_param_t*);
//   void get_version_info(char*, int);
//
// (struct layouts mirror edge/parameter_tuning/call_c_fun.py:20-58, and
// tuning/call_native.py of this package), and the same algorithm as the RoE
// engine (harmonic novelty with 3-smallest local-average SNR normalization,
// peak gating, TD pulse characteristics, FP/FN combining), so the
// Python<->native differential harness (tuning/classification_algo.py)
// works against it.
//
// Double precision throughout; firmware 2-second chunking.
//
// Build: tuning/call_native.py compiles this file at first use with
// `g++ -O3 -fPIC -shared -std=c++17` into build/ (with
// io/alac_native.py::build_library); DSP_NATIVE_LIB may name another build
// of the same ABI.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

using cplx = std::complex<double>;
constexpr double PI = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// ABI structs
// ---------------------------------------------------------------------------

struct evmgr_sensor_data_t {
    uint8_t sensor_id;
    uint8_t len;
    uint16_t reserved;
    float* buf;
};

struct evmgr_data_input_t {
    int audio_len;
    const char* raw_audiop;
    int image_len;
    const char* imagep;
    evmgr_sensor_data_t sensor_data;
};

#pragma pack(push, 1)
struct rain_cl_optional_data_t {
    uint16_t len;
    uint32_t version;
    uint32_t timestamp;
    uint32_t raindrops;
    float mean_freq[6];
    float rain_threshold[6];
    uint8_t buf[2];
};

struct rain_cl_config_param_t {
    uint32_t sample_rate;
    uint16_t freq_resolution;
    uint16_t time_resolution_ms;
    float check_duration;
    uint16_t op_freq_range[2];
    uint16_t n_freq_range[2];
    float harmonic_threshold[6];
    uint16_t fn;
    uint16_t num_harmonics;
    uint16_t max_peaks;
    uint16_t log_factor;
    uint16_t ns_duration_ms;
    float nf;
    float min_drop_count;
};
#pragma pack(pop)

// ---------------------------------------------------------------------------
// FFT (iterative radix-2)
// ---------------------------------------------------------------------------

void fft_inplace(std::vector<cplx>& a) {
    const size_t n = a.size();
    for (size_t i = 1, j = 0; i < n; ++i) {
        size_t bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(a[i], a[j]);
    }
    for (size_t len = 2; len <= n; len <<= 1) {
        const double ang = -2.0 * PI / static_cast<double>(len);
        const cplx wl(std::cos(ang), std::sin(ang));
        for (size_t i = 0; i < n; i += len) {
            cplx w(1.0);
            for (size_t k = 0; k < len / 2; ++k) {
                cplx u = a[i + k];
                cplx v = a[i + k + len / 2] * w;
                a[i + k] = u + v;
                a[i + k + len / 2] = u - v;
                w *= wl;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Butterworth biquad-cascade design (bilinear transform), lowpass prototype
// -> bandpass, matches scipy.signal.butter(..., output="sos") responses.
// ---------------------------------------------------------------------------

struct Biquad {
    double b0, b1, b2, a1, a2;
};

std::vector<Biquad> butter_bandpass(int order, double lo, double hi, double fs) {
    const double fs2 = 2.0;
    const double w1 = 2.0 * fs2 * std::tan(PI * (lo / (fs / 2.0)) / fs2);
    const double w2 = 2.0 * fs2 * std::tan(PI * (hi / (fs / 2.0)) / fs2);
    const double bw = w2 - w1;
    const double wo = std::sqrt(w1 * w2);

    // analog prototype poles
    std::vector<cplx> p;
    for (int k = 1; k <= order; ++k) {
        const double theta = PI * (2.0 * k - 1.0) / (2.0 * order) + PI / 2.0;
        p.emplace_back(std::cos(theta), std::sin(theta));
    }
    // lp2bp
    std::vector<cplx> p_bp;
    for (const auto& pk : p) {
        const cplx plp = pk * (bw / 2.0);
        const cplx s = std::sqrt(plp * plp - wo * wo);
        p_bp.push_back(plp + s);
        p_bp.push_back(plp - s);
    }
    const int degree = order;  // len(p) - len(z)
    double k_bp = std::pow(bw, degree);

    // zeros: `order` at s=0
    std::vector<cplx> z_bp(order, cplx(0.0, 0.0));

    // bilinear
    const double fs4 = 2.0 * fs2;
    std::vector<cplx> zd, pd;
    cplx num(1.0), den(1.0);
    for (const auto& z : z_bp) {
        zd.push_back((fs4 + z) / (fs4 - z));
        num *= (fs4 - z);
    }
    for (const auto& pp : p_bp) {
        pd.push_back((fs4 + pp) / (fs4 - pp));
        den *= (fs4 - pp);
    }
    for (size_t i = zd.size(); i < pd.size(); ++i) zd.emplace_back(-1.0, 0.0);
    double kd = k_bp * std::real(num / den);

    // pair conjugate poles with nearest zeros into biquads
    std::vector<cplx> z_pool = zd;
    std::vector<Biquad> sos;
    // take poles with positive imaginary part (conjugate representatives)
    std::vector<cplx> p_upper;
    for (const auto& pp : pd)
        if (pp.imag() > 1e-12) p_upper.push_back(pp);
    std::sort(p_upper.begin(), p_upper.end(),
              [](const cplx& a, const cplx& b) { return std::abs(a) > std::abs(b); });

    auto take_nearest = [&](const cplx& target) {
        size_t best = 0;
        double bd = 1e300;
        for (size_t i = 0; i < z_pool.size(); ++i) {
            const double d = std::abs(z_pool[i] - target);
            if (d < bd) { bd = d; best = i; }
        }
        const cplx zz = z_pool[best];
        z_pool.erase(z_pool.begin() + static_cast<long>(best));
        return zz;
    };

    for (const auto& pp : p_upper) {
        cplx zz = take_nearest(pp);
        double zb0 = 1.0, zb1, zb2;
        if (std::abs(zz.imag()) > 1e-12) {
            // conjugate zero pair: remove the conjugate from the pool too
            for (size_t i = 0; i < z_pool.size(); ++i) {
                if (std::abs(z_pool[i] - std::conj(zz)) < 1e-9) {
                    z_pool.erase(z_pool.begin() + static_cast<long>(i));
                    break;
                }
            }
            zb1 = -2.0 * zz.real();
            zb2 = std::norm(zz);
        } else {
            // grab another real zero
            cplx zz2 = take_nearest(pp);
            zb1 = -(zz.real() + zz2.real());
            zb2 = zz.real() * zz2.real();
        }
        Biquad bq;
        bq.b0 = zb0;
        bq.b1 = zb1;
        bq.b2 = zb2;
        bq.a1 = -2.0 * pp.real();
        bq.a2 = std::norm(pp);
        sos.push_back(bq);
    }
    if (!sos.empty()) {
        sos[0].b0 *= kd;
        sos[0].b1 *= kd;
        sos[0].b2 *= kd;
    }
    return sos;
}

void sosfilt(const std::vector<Biquad>& sos, std::vector<double>& x) {
    for (const auto& s : sos) {
        double z0 = 0.0, z1 = 0.0;
        for (double& v : x) {
            const double xin = v;
            const double y = s.b0 * xin + z0;
            z0 = s.b1 * xin - s.a1 * y + z1;
            z1 = s.b2 * xin - s.a2 * y;
            v = y;
        }
    }
}

// ---------------------------------------------------------------------------
// Algorithm pieces (mirrors models/roe.py semantics)
// ---------------------------------------------------------------------------

struct RoeParams {
    double fs;
    int frame_length;
    int hop_length;
    int min_average_len;
    double op_lo, op_hi;
    double n_lo, n_hi;
    double fn;
    int num_harmonics;
    double thr[6];
    double rain_thr_hn;
    int max_peaks;
    double min_drop_count;
};

int next_pow2_exp(double v) {
    int e = 0;
    while ((1 << e) < v) ++e;
    return e;
}

// centered STFT magnitude; returns (F=frame/2+1) x T row-major
void stft_mag(const std::vector<double>& x, int n_fft, int hop,
              std::vector<double>& mag, int& F, int& T) {
    const int pad = n_fft / 2;
    std::vector<double> xp(x.size() + 2 * pad, 0.0);
    std::copy(x.begin(), x.end(), xp.begin() + pad);
    T = 1 + static_cast<int>((xp.size() - n_fft) / hop);
    F = n_fft / 2 + 1;
    mag.assign(static_cast<size_t>(F) * T, 0.0);
    std::vector<double> win(n_fft);
    for (int i = 0; i < n_fft; ++i)
        win[i] = 0.5 - 0.5 * std::cos(2.0 * PI * i / n_fft);
    std::vector<cplx> buf(n_fft);
    for (int t = 0; t < T; ++t) {
        for (int i = 0; i < n_fft; ++i)
            buf[i] = cplx(xp[t * hop + i] * win[i], 0.0);
        fft_inplace(buf);
        for (int f = 0; f < F; ++f)
            mag[static_cast<size_t>(f) * T + t] = std::abs(buf[f]);
    }
}

// novelty spectrum for a band-masked magnitude block (length T+1 output)
void novelty_spectrum(const std::vector<double>& mag, int F, int T,
                      int idx1, int idx2, int M, double thr,
                      std::vector<double>& nov_out) {
    std::vector<double> nov(T + 1, 0.0);
    for (int t = 0; t < T; ++t) {
        double s = 0.0;
        for (int f = 1; f < F; ++f) {
            const double cur = (f >= idx1 && f <= idx2)
                                   ? mag[static_cast<size_t>(f) * T + t] : 0.0;
            const double prev = ((f - 1) >= idx1 && (f - 1) <= idx2)
                                    ? mag[static_cast<size_t>(f - 1) * T + t] : 0.0;
            const double d = cur - prev;
            if (d > 0) s += d;
        }
        nov[t] = s;
    }
    const int L = T + 1;

    // local average: mean of the 3 smallest in +-M
    std::vector<double> la(L);
    double nov_max = 0.0;
    for (double v : nov) nov_max = std::max(nov_max, v);
    for (int m = 0; m < L; ++m) {
        const int a = std::max(m - M, 0);
        const int b = std::min(m + M + 1, L);
        double s0 = 1e300, s1 = 1e300, s2 = 1e300;
        for (int i = a; i < b; ++i) {
            const double v = nov[i];
            if (v < s0) { s2 = s1; s1 = s0; s0 = v; }
            else if (v < s1) { s2 = s1; s1 = v; }
            else if (v < s2) { s2 = v; }
        }
        la[m] = (s0 + s1 + s2) / 3.0;
        if (la[m] <= 0) la[m] = nov_max / 5.0;
        if (la[m] == 0) la[m] = 1.0;
    }
    for (int m = 0; m < L; ++m) {
        double v = nov[m];
        if (v == 0) v = 1.0;
        nov[m] = v / la[m];
    }
    // peak mask + threshold clip
    nov_out.assign(L, 0.0);
    for (int m = 1; m < L - 1; ++m) {
        if (nov[m] > nov[m - 1] && nov[m] > nov[m + 1]) {
            double v = nov[m];
            if (v > thr) nov_out[m] = std::min(v, thr * 1.5);
        }
    }
}

// first peak in accept range among the first max_peaks peaks in search range
void find_first_peak(const std::vector<double>& mag, int F, int T,
                     double s_lo, double s_hi, double a_lo, double a_hi,
                     double fs, int max_peaks,
                     std::vector<int>& found, std::vector<double>& fpeak) {
    const double fn_half = fs / 2.0;
    const int bin_lo = static_cast<int>(s_lo * F / fn_half);
    const int bin_hi = static_cast<int>(s_hi * F / fn_half);
    found.assign(T, 0);
    fpeak.assign(T, 0.0);
    for (int t = 0; t < T; ++t) {
        int count = 0;
        for (int f = bin_lo + 1; f < bin_hi - 1 && f < F - 1 && count < max_peaks;
             ++f) {
            if (f <= 0) continue;
            const double c = mag[static_cast<size_t>(f) * T + t];
            if (c > mag[static_cast<size_t>(f - 1) * T + t] &&
                c > mag[static_cast<size_t>(f + 1) * T + t]) {
                const double freq = static_cast<double>(f) * fn_half / F;
                ++count;
                if (freq > a_lo && freq < a_hi) {
                    found[t] = 1;
                    fpeak[t] = freq;
                    break;
                }
            }
        }
    }
}

double nonzero_mean(const std::vector<double>& v) {
    double s = 0.0;
    int c = 0;
    for (double x : v)
        if (x != 0) { s += x; ++c; }
    return c ? s / c : 0.0;
}

struct ChunkResult {
    int rain_drops = 0;
    double frain_mean = 0.0;
    std::vector<double> kurt, crest, diff_energy;
};

void pulse_characteristics(const std::vector<double>& audio, int num_frames,
                           const RoeParams& P, ChunkResult& out) {
    const int N = P.frame_length, H = P.hop_length;
    std::vector<double> padded(audio.size() + 2 * H, 0.0);
    std::copy(audio.begin(), audio.end(), padded.begin() + H);
    std::vector<double> filt = padded;
    auto sos = butter_bandpass(4, 400.0, 900.0, P.fs);
    sosfilt(sos, filt);

    std::vector<double> energy(num_frames, 0.0);
    const int n_e = 1 + static_cast<int>((filt.size() - N) / H);
    for (int i = 0; i < std::min(num_frames, n_e); ++i) {
        double e = 0.0;
        for (int k = 0; k < N; ++k) e += filt[i * H + k] * filt[i * H + k];
        energy[i] = e;
    }

    out.kurt.assign(num_frames + 1, 0.0);
    out.crest.assign(num_frames + 1, 0.0);
    out.diff_energy.assign(num_frames + 1, 0.0);

    for (int i = 0; i < num_frames; ++i) {
        if (i >= 2) {
            double last = energy[i - 1];
            if (energy[i - 2] < energy[i - 1]) last = energy[i - 2];
            if (energy[i] > last)
                out.diff_energy[i] = energy[i] / (last + 1e-12);
        }
        if (i > 0 && static_cast<size_t>(i * H + N) <= padded.size()) {
            double mean = 0.0;
            for (int k = 0; k < N; ++k) mean += padded[i * H + k];
            mean /= N;
            double m2 = 0.0, m4 = 0.0, peak = 0.0, msq = 0.0;
            for (int k = 0; k < N; ++k) {
                const double v = padded[i * H + k];
                const double d = v - mean;
                m2 += d * d;
                m4 += d * d * d * d;
                peak = std::max(peak, std::fabs(v));
                msq += v * v;
            }
            m2 /= N;
            m4 /= N;
            out.kurt[i] = (m2 > 0) ? (m4 / (m2 * m2) - 3.0) : -3.0;
            out.crest[i] = peak / (std::sqrt(msq / N) + 1e-12);
        }
    }
}

ChunkResult analyse_chunk(const std::vector<double>& chunk, const RoeParams& P) {
    ChunkResult res;
    // operating-band causal bandpass, order 8
    std::vector<double> audio = chunk;
    auto sos = butter_bandpass(8, P.op_lo, P.op_hi, P.fs);
    sosfilt(sos, audio);

    std::vector<double> mag;
    int F = 0, T = 0;
    stft_mag(audio, P.frame_length, P.hop_length, mag, F, T);

    pulse_characteristics(audio, T, P, res);

    const double f_res = P.fs / P.frame_length;
    auto band_idx = [&](double f1, double f2, int& i1, int& i2) {
        i1 = static_cast<int>(std::floor(f1 / f_res)) + 1;
        i2 = static_cast<int>(std::floor(f2 / f_res));
    };

    const int n_h = P.num_harmonics;  // total incl. harmonic 0
    std::vector<std::vector<double>> nov(n_h);

    // harmonic 0
    int i1, i2;
    band_idx(P.fn, P.fn + 300.0, i1, i2);
    novelty_spectrum(mag, F, T, i1, i2, P.min_average_len, P.thr[0], nov[0]);
    std::vector<int> found0;
    std::vector<double> fpeak0;
    find_first_peak(mag, F, T, P.op_lo, P.op_hi, P.fn, P.fn + 300.0, P.fs,
                    P.max_peaks, found0, fpeak0);
    for (int t = 0; t < T; ++t)
        if (nov[0][t] != 0 && found0[t] == 0) nov[0][t] = 0.0;
    res.frain_mean = nonzero_mean(fpeak0);

    const bool in_natural =
        res.frain_mean >= P.n_lo && res.frain_mean <= P.n_hi;
    const bool overflow_last =
        (res.frain_mean * P.num_harmonics + 300.0) > (P.op_hi + 100.0);

    for (int hn = 1; hn < n_h; ++hn) {
        nov[hn].assign(T + 1, 0.0);
        const bool active = in_natural && !(hn == n_h - 1 && overflow_last);
        if (!active) continue;
        const double f1 = res.frain_mean * (hn + 1) - 100.0;
        band_idx(f1, f1 + 300.0, i1, i2);
        std::vector<double> novx;
        novelty_spectrum(mag, F, T, i1, i2, P.min_average_len,
                         P.thr[std::min(hn, 5)], novx);
        const double s_lo = std::max(res.frain_mean * (hn + 1) - 200.0, P.op_lo);
        const double s_hi = std::min(res.frain_mean * (hn + 1) + 300.0, P.op_hi);
        std::vector<int> fh;
        std::vector<double> fph;
        find_first_peak(mag, F, T, s_lo, s_hi, f1, f1 + 300.0, P.fs,
                        P.max_peaks, fh, fph);
        for (int t = 0; t < T; ++t)
            if (novx[t] != 0 && fph[t] == 0) novx[t] = 0.0;
        nov[hn] = novx;
    }

    // base gating + sum + threshold
    for (int t = 0; t < T + 1; ++t) {
        if (nov[0][t] == 0)
            for (int hn = 1; hn < n_h; ++hn) nov[hn][t] = 0.0;
        double s = 0.0;
        for (int hn = 0; hn < n_h; ++hn) s += nov[hn][t];
        if (s >= P.rain_thr_hn) ++res.rain_drops;
    }
    return res;
}

std::string g_version = "tpu-native-roe 0.1.0 (audio_processing_tools_tpu_torch)";

}  // namespace

extern "C" {

int sample_classifier_to_evaluate_impl(evmgr_data_input_t* input,
                                       rain_cl_optional_data_t* opt,
                                       rain_cl_config_param_t* cfg) {
    if (!input || !cfg || !input->raw_audiop || input->audio_len < 2) return -1;

    RoeParams P;
    P.fs = cfg->sample_rate ? cfg->sample_rate : 11162;
    P.frame_length = 1 << next_pow2_exp(P.fs / std::max<int>(cfg->freq_resolution, 1));
    P.hop_length =
        1 << next_pow2_exp(cfg->time_resolution_ms * P.fs / 1000.0);
    const double ns_ms = cfg->ns_duration_ms;
    P.min_average_len = static_cast<int>(
        std::ceil(((ns_ms * P.fs / 1000.0) / P.hop_length - 1.0) / 2.0));
    P.op_lo = cfg->op_freq_range[0];
    P.op_hi = cfg->op_freq_range[1];
    P.n_lo = cfg->n_freq_range[0];
    P.n_hi = cfg->n_freq_range[1];
    P.fn = cfg->fn;
    P.num_harmonics = std::min<int>(std::max<int>(cfg->num_harmonics, 1), 6);
    for (int i = 0; i < 6; ++i) P.thr[i] = cfg->harmonic_threshold[i];
    P.rain_thr_hn = P.thr[0] + P.thr[1] + P.thr[2];
    P.max_peaks = std::max<int>(cfg->max_peaks, 1);
    P.min_drop_count = cfg->min_drop_count;

    // int16 -> double in [-1, 1] (scale 32767, cf. call_c_fun read path)
    const int n_samples = input->audio_len / 2;
    const int16_t* pcm = reinterpret_cast<const int16_t*>(input->raw_audiop);
    std::vector<double> x(n_samples);
    for (int i = 0; i < n_samples; ++i) x[i] = pcm[i] / 32767.0;

    // firmware chunking (2-s parts)
    const double duration = cfg->check_duration > 0 ? cfg->check_duration : 10.0;
    double remaining = duration, offset = 0.0;
    int rain_drop_count = 0;
    double frain_mean = 0.0;
    std::vector<double> kurt_all, crest_all, de_all;
    while (remaining > 0) {
        const double part = std::min(remaining, 2.0);
        const double n_frames = part * P.fs / P.frame_length;
        const int read_size = static_cast<int>(P.frame_length * n_frames);
        const int read_off = static_cast<int>(P.fs * offset);
        remaining -= part;
        offset += part;
        if (read_off >= n_samples || n_samples - read_off < P.fs) continue;
        const int take = std::min(read_size, n_samples - read_off);
        std::vector<double> chunk(x.begin() + read_off,
                                  x.begin() + read_off + take);
        ChunkResult r = analyse_chunk(chunk, P);
        rain_drop_count += r.rain_drops;
        frain_mean = r.frain_mean;
        kurt_all.insert(kurt_all.end(), r.kurt.begin(), r.kurt.end());
        crest_all.insert(crest_all.end(), r.crest.begin(), r.crest.end());
        de_all.insert(de_all.end(), r.diff_energy.begin(), r.diff_energy.end());
    }

    const int rain_drop_threshold =
        static_cast<int>(std::ceil(P.min_drop_count * duration));
    bool raining = rain_drop_count > rain_drop_threshold;

    // TD gate + FP/FN combiner (fixed legacy thresholds)
    int rain_peaks_count = 0;
    for (size_t i = 0; i < kurt_all.size(); ++i)
        if (kurt_all[i] > 2.5 && crest_all[i] > 3.75 && de_all[i] > 6.5)
            ++rain_peaks_count;

    int mod = rain_drop_count;
    // handle_fn
    if (!raining && (rain_drop_count > 50 || rain_peaks_count > 30)) {
        raining = true;
        mod = std::max(rain_drop_count, rain_peaks_count);
    }
    // handle_fp
    if (raining &&
        (rain_peaks_count < 9 || rain_drop_count < rain_drop_threshold)) {
        raining = false;
        mod = 0;
    }
    if (!raining) mod = 0;

    if (opt) {
        std::memset(opt, 0, sizeof(*opt));
        opt->len = sizeof(*opt);
        opt->version = 0x00010000;
        opt->raindrops = static_cast<uint32_t>(std::max(mod, 0));
        opt->mean_freq[0] = static_cast<float>(frain_mean);
        for (int i = 0; i < 6; ++i)
            opt->rain_threshold[i] = static_cast<float>(P.thr[i]);
    }
    return mod;
}

void get_version_info(char* buf, int len) {
    if (!buf || len <= 0) return;
    std::strncpy(buf, g_version.c_str(), static_cast<size_t>(len - 1));
    buf[len - 1] = '\0';
}

// Legacy symbol aliases exported by the reference dylib.
int rain_cl_main(evmgr_data_input_t* input, rain_cl_optional_data_t* opt,
                 rain_cl_config_param_t* cfg) {
    return sample_classifier_to_evaluate_impl(input, opt, cfg);
}

void rain_cl_version_info(char* buf, int len) { get_version_info(buf, len); }

}  // extern "C"
