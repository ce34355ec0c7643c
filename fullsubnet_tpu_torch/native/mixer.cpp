// Host-side DSP core of the training-data pipeline (the port's copy of the
// JAX package's mixer, the same C ABI and arithmetic).
//
// The per-item mix of the training set (reference dataset_train.py:136-195:
// RIR convolution, amplitude and loudness normalisation, SNR mixing, clip
// rescue) runs in one call that holds no Python lock, so each of the
// loader's worker processes spends its time in compiled code while the card
// trains on the batches they made before.
//
// A plain C ABI read through ctypes (fullsubnet_tpu_torch/native/__init__.py
// builds it with g++ at first use).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC mixer.cpp -o libfsn_mixer.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

// --------------------------------------------------------------------------
// FFT engine: iterative radix-2 on split (SoA) re/im arrays with cached
// bit-reversal + twiddle tables, and real transforms done as HALF-size
// complex FFTs. Replaces the original textbook complex FFT (on-the-fly
// `w *= wlen` twiddles, 3 full-size complex transforms per convolution):
// the table+SoA butterflies auto-vectorize and the real-packing halves
// the transform size, ~5x end-to-end on the RIR convolution.
// --------------------------------------------------------------------------

struct FftTables {
  std::vector<int32_t> rev;       // bit-reversal permutation (size n)
  std::vector<float> twre, twim;  // e^{-2*pi*i*k/n}, k = 0..n/2-1
};

const FftTables& tables_for(int64_t n) {
  static std::mutex mu;
  static std::unordered_map<int64_t, std::unique_ptr<FftTables>> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto& slot = cache[n];
  if (!slot) {
    slot.reset(new FftTables);
    slot->rev.assign(n, 0);
    for (int64_t i = 1, j = 0; i < n; ++i) {
      int64_t bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      slot->rev[i] = int32_t(j);
    }
    slot->twre.resize(n / 2);
    slot->twim.resize(n / 2);
    for (int64_t k = 0; k < n / 2; ++k) {
      const double ang = -2.0 * M_PI * double(k) / double(n);
      slot->twre[k] = float(std::cos(ang));
      slot->twim[k] = float(std::sin(ang));
    }
  }
  return *slot;
}

// In-place complex FFT on split arrays; n a power of two.
void fft_soa(float* re, float* im, int64_t n, bool inverse) {
  const FftTables& t = tables_for(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t j = t.rev[i];
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  const float isign = inverse ? -1.0f : 1.0f;  // tables hold e^{-...}
  const float* twre = t.twre.data();
  const float* twim = t.twim.data();
  for (int64_t len = 2; len <= n; len <<= 1) {
    const int64_t half = len >> 1;
    const int64_t step = n / len;
    for (int64_t i = 0; i < n; i += len) {
      float* rea = re + i;
      float* ima = im + i;
      float* reb = rea + half;
      float* imb = ima + half;
      for (int64_t k = 0; k < half; ++k) {
        const float wr = twre[k * step];
        const float wi = isign * twim[k * step];
        const float vr = reb[k] * wr - imb[k] * wi;
        const float vi = reb[k] * wi + imb[k] * wr;
        reb[k] = rea[k] - vr;
        imb[k] = ima[k] - vi;
        rea[k] += vr;
        ima[k] += vi;
      }
    }
  }
  if (inverse) {
    const float inv = 1.0f / float(n);
    for (int64_t i = 0; i < n; ++i) {
      re[i] *= inv;
      im[i] *= inv;
    }
  }
}

// rfft of real a[0..n-1] (n a power of two >= 4) via a complex FFT of
// size n/2. Writes n/2+1 spectrum bins; work arrays hold n/2 floats.
void rfft(const float* a, int64_t n, float* outre, float* outim,
          float* workre, float* workim) {
  const int64_t n2 = n / 2;
  for (int64_t j = 0; j < n2; ++j) {
    workre[j] = a[2 * j];
    workim[j] = a[2 * j + 1];
  }
  fft_soa(workre, workim, n2, false);
  const FftTables& tf = tables_for(n);  // e^{-2*pi*i*k/n}
  outre[0] = workre[0] + workim[0];
  outim[0] = 0.0f;
  outre[n2] = workre[0] - workim[0];
  outim[n2] = 0.0f;
  for (int64_t k = 1; k < n2; ++k) {
    const int64_t kr = n2 - k;
    const float zer = 0.5f * (workre[k] + workre[kr]);
    const float zei = 0.5f * (workim[k] - workim[kr]);
    const float zor = 0.5f * (workim[k] + workim[kr]);
    const float zoi = -0.5f * (workre[k] - workre[kr]);
    const float wr = tf.twre[k];
    const float wi = tf.twim[k];
    outre[k] = zer + wr * zor - wi * zoi;
    outim[k] = zei + wr * zoi + wi * zor;
  }
}

// irfft of a conj-symmetric spectrum y[0..n/2] back to n real samples,
// again via one n/2-point complex FFT.
void irfft(const float* yre, const float* yim, int64_t n, float* out,
           float* workre, float* workim) {
  const int64_t n2 = n / 2;
  const FftTables& tf = tables_for(n);
  for (int64_t k = 0; k < n2; ++k) {
    const int64_t kr = n2 - k;
    const float ar = yre[k], ai = yim[k];
    const float br = yre[kr], bi = -yim[kr];  // conj(Y[n2-k])
    const float yer = 0.5f * (ar + br), yei = 0.5f * (ai + bi);
    const float yor = 0.5f * (ar - br), yoi = 0.5f * (ai - bi);
    const float wr = tf.twre[k];
    const float wi = -tf.twim[k];  // e^{+2*pi*i*k/n}
    const float tr = yor * wr - yoi * wi;
    const float ti = yor * wi + yoi * wr;
    workre[k] = yer - ti;  // Ze + i*(W^{+k} Zo)
    workim[k] = yei + tr;
  }
  fft_soa(workre, workim, n2, true);
  for (int64_t j = 0; j < n2; ++j) {
    out[2 * j] = workre[j];
    out[2 * j + 1] = workim[j];
  }
}

int64_t next_pow2(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

double rms(const float* x, int64_t n) {
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += double(x[i]) * double(x[i]);
  return std::sqrt(acc / double(n));
}

double peak(const float* x, int64_t n) {
  double m = 0.0;
  for (int64_t i = 0; i < n; ++i) m = std::max(m, double(std::fabs(x[i])));
  return m;
}

void scale(float* x, int64_t n, double s) {
  for (int64_t i = 0; i < n; ++i) x[i] = float(double(x[i]) * s);
}

}  // namespace

extern "C" {

// Linear convolution of x (n) with h (m), truncated to the first n samples
// (the reference keeps fftconvolve(clean, rir)[:len(clean)]).
void fsn_fft_convolve_trunc(const float* x, int64_t n, const float* h,
                            int64_t m, float* out) {
  const int64_t full = n + m - 1;
  int64_t size = next_pow2(full);
  if (size < 4) size = 4;
  const int64_t n2 = size / 2;
  std::vector<float> pad(size, 0.0f);
  std::vector<float> xre(n2 + 1), xim(n2 + 1), hre(n2 + 1), him(n2 + 1);
  std::vector<float> wre(n2), wim(n2);
  std::memcpy(pad.data(), x, sizeof(float) * n);
  rfft(pad.data(), size, xre.data(), xim.data(), wre.data(), wim.data());
  std::memset(pad.data(), 0, sizeof(float) * size);
  std::memcpy(pad.data(), h, sizeof(float) * m);
  rfft(pad.data(), size, hre.data(), him.data(), wre.data(), wim.data());
  for (int64_t k = 0; k <= n2; ++k) {
    const float r = xre[k] * hre[k] - xim[k] * him[k];
    const float i = xre[k] * him[k] + xim[k] * hre[k];
    xre[k] = r;
    xim[k] = i;
  }
  irfft(xre.data(), xim.data(), size, pad.data(), wre.data(), wim.data());
  std::memcpy(out, pad.data(), sizeof(float) * n);
}

// Full SNR mix (reference dataset_train.py:136-195 semantics).
//
// Inputs are modified copies: clean/noise are buffers of length n the
// caller owns; rir may be null (no reverb). snr in dB;
// noisy_target_dbfs already drawn by the caller (keeps RNG in one place).
// Writes noisy and (scaled) clean in place.
void fsn_snr_mix(float* clean, float* noise, int64_t n, const float* rir,
                 int64_t rir_len, float snr, float target_dbfs,
                 float noisy_target_dbfs, float eps) {
  std::vector<float> reverbed;
  if (rir != nullptr && rir_len > 0) {
    reverbed.resize(n);
    fsn_fft_convolve_trunc(clean, n, rir, rir_len, reverbed.data());
    std::memcpy(clean, reverbed.data(), sizeof(float) * n);
  }

  // norm_amplitude + tailor_dB_FS(clean)
  scale(clean, n, 1.0 / (peak(clean, n) + eps));
  scale(clean, n, std::pow(10.0, target_dbfs / 20.0) / (rms(clean, n) + eps));
  const double clean_rms = rms(clean, n);

  scale(noise, n, 1.0 / (peak(noise, n) + eps));
  scale(noise, n, std::pow(10.0, target_dbfs / 20.0) / (rms(noise, n) + eps));
  const double noise_rms = rms(noise, n);

  const double snr_scalar =
      clean_rms / std::pow(10.0, snr / 20.0) / (noise_rms + eps);
  for (int64_t i = 0; i < n; ++i)
    noise[i] = float(double(noise[i]) * snr_scalar);

  // noisy = clean + noise, re-targeted loudness; clean scaled alike
  std::vector<float> noisy(n);
  for (int64_t i = 0; i < n; ++i) noisy[i] = clean[i] + noise[i];
  const double noisy_scalar =
      std::pow(10.0, noisy_target_dbfs / 20.0) / (rms(noisy.data(), n) + eps);
  for (int64_t i = 0; i < n; ++i) {
    noisy[i] = float(double(noisy[i]) * noisy_scalar);
    clean[i] = float(double(clean[i]) * noisy_scalar);
  }

  // clip rescue (threshold 0.999, rescale to 0.99 - eps)
  const double pk = peak(noisy.data(), n);
  if (pk > 0.999) {
    const double rescale = pk / (0.99 - eps);
    for (int64_t i = 0; i < n; ++i) {
      noisy[i] = float(double(noisy[i]) / rescale);
      clean[i] = float(double(clean[i]) / rescale);
    }
  }
  std::memcpy(noise, noisy.data(), sizeof(float) * n);  // noise buf := noisy
}

// 50 ms-window frame energies in dB (VAD front half, feature.py:207-255).
void fsn_frame_energies_db(const float* x, int64_t n, int64_t window,
                           float eps, float* out, int64_t* out_n) {
  int64_t cnt = 0;
  for (int64_t start = 0; start < n; start += window) {
    const int64_t end = std::min(start + window, n);
    double acc = 0.0;
    for (int64_t i = start; i < end; ++i) acc += double(x[i]) * double(x[i]);
    out[cnt++] = float(20.0 * std::log10(acc + eps));
  }
  *out_n = cnt;
}

int fsn_abi_version() { return 1; }

}  // extern "C"
