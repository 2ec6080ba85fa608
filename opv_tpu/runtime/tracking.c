/*
 * _tracking — native symbol-tracking runtime for opv_tpu.
 *
 * The reference-parity demodulator is a serial per-symbol feedback loop
 * (AFC + early-late TED, src/opv-demod.cpp:206-329).  The JAX lax.scan
 * formulation (opv_tpu/rx/demod.py) is the batched implementation; on
 * a host CPU its per-step overhead caps one stream at ~1.9 MS/s — below
 * the 2.168 MS/s real-time line the reference's C++ loop clears at
 * 4.77 MS/s.  This module is the framework's native runtime for that one
 * serial loop: the same operations in the same order as rx/demod.py's
 * scan body (which itself mirrors the reference operation-for-operation),
 * in double precision, exposed via the CPython C API (no pybind11 / numpy
 * C-API dependency).  Everything downstream (sync scan, Viterbi, frame
 * finishing) stays in JAX — see rx/pipeline.py::rx_block_from_soft.
 *
 * Numerics: per-sample arithmetic matches the scan body exactly; the only
 * permitted divergence from XLA:CPU output is reduction association in
 * the six 40-tap correlation sums (XLA may tree-reduce SIMD lanes), which
 * perturbs soft values at ulp scale.  Parity is therefore asserted at the
 * decoded-frame level (tests/test_native_tracking.py), the project's
 * bit-exactness standard (CLAUDE.md).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

#define SPS 40
#define EL 10
#define TWO_PI 6.283185307179586476925286766559

/* params vector layout (doubles), versioned by length:
 *  [0] freq_dev          [1] sample_rate       [2] symbol_rate
 *  [3] alpha_timing      [4] beta_timing       [5] timing_freq_clamp
 *  [6] timing_adj_clamp  [7] afc_clamp_hz      [8] afc_alpha
 */
#define NPARAMS 9

/* state vector layout (doubles):
 *  [0] mu  [1] phase_f1  [2] phase_f2  [3] freq_offset  [4] timing_freq
 *  [5] prev_c1.re  [6] prev_c1.im  [7] prev_c2.re  [8] prev_c2.im
 */
#define NSTATE 9

static inline double wrap_pi(double p) {
  /* single conditional wrap, matching rx/demod.py::_wrap_pi (the scan
   * applies at most one correction per symbol; increments are < pi) */
  if (p > M_PI) p -= TWO_PI;
  if (p < -M_PI) p += TWO_PI;
  return p;
}

static inline void interp(const double *re, const double *im, Py_ssize_t cap,
                          double rel, double *or_, double *oi) {
  /* linear interpolation with the scan's clamp semantics (rx/demod.py
   * interp_window): clamp only binds at the buffer edges, which active
   * steps never reach */
  if (rel < 0.0) rel = 0.0;
  Py_ssize_t i0 = (Py_ssize_t)rel;
  if (i0 > cap - 2) i0 = cap - 2;
  double f = rel - (double)i0;
  *or_ = re[i0] * (1.0 - f) + re[i0 + 1] * f;
  *oi = im[i0] * (1.0 - f) + im[i0 + 1] * f;
}

/* track_block(samples_c128_bytes, n_valid, state_bytes, params_bytes,
 *             max_out)
 *   -> (soft_bytes_f64[max_out], n_sym, new_state_bytes, samples_used)
 *
 * samples: complex128 little-endian interleaved (re, im) buffer of the
 * FULL capacity; only the first n_valid samples are data.  The caller
 * wraps soft_bytes with np.frombuffer(float64).
 */
static PyObject *track_block(PyObject *self, PyObject *args) {
  Py_buffer in, stb, prm;
  long n_valid_l;
  long max_out;
  if (!PyArg_ParseTuple(args, "y*ly*y*l", &in, &n_valid_l, &stb, &prm,
                        &max_out))
    return NULL;
  if (stb.len != NSTATE * (Py_ssize_t)sizeof(double) ||
      prm.len != NPARAMS * (Py_ssize_t)sizeof(double)) {
    PyBuffer_Release(&in);
    PyBuffer_Release(&stb);
    PyBuffer_Release(&prm);
    PyErr_SetString(PyExc_ValueError, "bad state/params length");
    return NULL;
  }
  const double *p = (const double *)prm.buf;
  const double fd = p[0], fs = p[1], sr = p[2];
  const double alpha_t = p[3], beta_t = p[4];
  const double tf_clamp = p[5], adj_clamp = p[6];
  const double afc_clamp = p[7], afc_alpha = p[8];

  Py_ssize_t cap = in.len / 16; /* complex128 */
  Py_ssize_t n_valid = (Py_ssize_t)n_valid_l;
  if (n_valid > cap) n_valid = cap;

  PyObject *soft_b =
      PyBytes_FromStringAndSize(NULL, max_out * (Py_ssize_t)sizeof(double));
  PyObject *st_b = PyBytes_FromStringAndSize(NULL, NSTATE * sizeof(double));
  if (!soft_b || !st_b) {
    Py_XDECREF(soft_b);
    Py_XDECREF(st_b);
    PyBuffer_Release(&in);
    PyBuffer_Release(&stb);
    PyBuffer_Release(&prm);
    return NULL;
  }
  double *soft_out = (double *)PyBytes_AS_STRING(soft_b);
  memset(soft_out, 0, max_out * sizeof(double));
  double st[NSTATE];
  memcpy(st, stb.buf, sizeof(st));

  /* deinterleave view: the complex128 buffer is (re, im) pairs */
  const double *base = (const double *)in.buf;
  long n_sym = 0;
  Py_ssize_t pos = 0;

  Py_BEGIN_ALLOW_THREADS {
    double mu = st[0], ph1 = st[1], ph2 = st[2];
    double foff = st[3], tfreq = st[4];
    double pc1re = st[5], pc1im = st[6], pc2re = st[7], pc2im = st[8];
    const double first_re = base[0], first_im = base[1];
    long emitted = 0;

    /* strided access helpers: sample k -> base[2k], base[2k+1].  interp()
     * wants separate re/im arrays with unit stride in SAMPLES; emulate by
     * indexing pairs directly. */
    while (pos < n_valid - (SPS + EL) && n_sym < max_out) {
      const double inc1 = TWO_PI * (-fd + foff) / fs;
      const double inc2 = TWO_PI * (fd + foff) / fs;
      double c1re = 0, c1im = 0, c2re = 0, c2im = 0;
      double c1ere = 0, c1eim = 0, c2ere = 0, c2eim = 0;
      double c1lre = 0, c1lim = 0, c2lre = 0, c2lim = 0;
      for (int i = 0; i < SPS; ++i) {
        const double rel = (double)pos + mu + (double)i;
        double sre, sim, ere, eim, lre, lim;
        /* on-time */
        {
          double r = rel < 0.0 ? 0.0 : rel;
          Py_ssize_t i0 = (Py_ssize_t)r;
          if (i0 > cap - 2) i0 = cap - 2;
          double f = r - (double)i0;
          sre = base[2 * i0] * (1.0 - f) + base[2 * (i0 + 1)] * f;
          sim = base[2 * i0 + 1] * (1.0 - f) + base[2 * (i0 + 1) + 1] * f;
        }
        /* early: pos + i < EL uses the stream's first sample
         * (rx/demod.py e_neg, mirroring opv-demod.cpp:122-128) */
        if (pos + i < EL) {
          ere = first_re;
          eim = first_im;
        } else {
          double r = rel - (double)EL;
          if (r < 0.0) r = 0.0;
          Py_ssize_t i0 = (Py_ssize_t)r;
          if (i0 > cap - 2) i0 = cap - 2;
          double f = r - (double)i0;
          ere = base[2 * i0] * (1.0 - f) + base[2 * (i0 + 1)] * f;
          eim = base[2 * i0 + 1] * (1.0 - f) + base[2 * (i0 + 1) + 1] * f;
        }
        /* late */
        {
          double r = rel + (double)EL;
          if (r < 0.0) r = 0.0;
          Py_ssize_t i0 = (Py_ssize_t)r;
          if (i0 > cap - 2) i0 = cap - 2;
          double f = r - (double)i0;
          lre = base[2 * i0] * (1.0 - f) + base[2 * (i0 + 1)] * f;
          lim = base[2 * i0 + 1] * (1.0 - f) + base[2 * (i0 + 1) + 1] * f;
        }
        const double a1 = ph1 + (double)i * inc1;
        const double a2 = ph2 + (double)i * inc2;
        const double co1 = cos(a1), sn1 = sin(a1);
        const double co2 = cos(a2), sn2 = sin(a2);
        /* s * conj(lo) accumulate */
        c1re += sre * co1 + sim * sn1;
        c1im += sim * co1 - sre * sn1;
        c2re += sre * co2 + sim * sn2;
        c2im += sim * co2 - sre * sn2;
        c1ere += ere * co1 + eim * sn1;
        c1eim += eim * co1 - ere * sn1;
        c2ere += ere * co2 + eim * sn2;
        c2eim += eim * co2 - ere * sn2;
        c1lre += lre * co1 + lim * sn1;
        c1lim += lim * co1 - lre * sn1;
        c2lre += lre * co2 + lim * sn2;
        c2lim += lim * co2 - lre * sn2;
      }
      ph1 = wrap_pi(ph1 + SPS * inc1);
      ph2 = wrap_pi(ph2 + SPS * inc2);

      const double e1 = c1re * c1re + c1im * c1im;
      const double e2 = c2re * c2re + c2im * c2im;
      soft_out[n_sym] = e2 - e1;
      const int f1_dom = e1 > e2;

      const double ee = f1_dom ? c1ere * c1ere + c1eim * c1eim
                               : c2ere * c2ere + c2eim * c2eim;
      const double el = f1_dom ? c1lre * c1lre + c1lim * c1lim
                               : c2lre * c2lre + c2lim * c2lim;
      const double ted = (el - ee) / (el + ee + 1e-10);
      tfreq += beta_t * ted;
      if (tfreq > tf_clamp) tfreq = tf_clamp;
      if (tfreq < -tf_clamp) tfreq = -tf_clamp;
      double adj = alpha_t * ted + tfreq;
      if (adj > adj_clamp) adj = adj_clamp;
      if (adj < -adj_clamp) adj = -adj_clamp;

      if (emitted >= 1) {
        const double dre = f1_dom ? c1re : c2re;
        const double dim = f1_dom ? c1im : c2im;
        const double pre = f1_dom ? pc1re : pc2re;
        const double pim = f1_dom ? pc1im : pc2im;
        /* arg(dom * conj(prev)) */
        const double xre = dre * pre + dim * pim;
        const double xim = dim * pre - dre * pim;
        const double pd = atan2(xim, xre);
        const double ferr = pd * sr / TWO_PI;
        foff += afc_alpha * ferr;
        if (foff > afc_clamp) foff = afc_clamp;
        if (foff < -afc_clamp) foff = -afc_clamp;
      }
      pc1re = c1re;
      pc1im = c1im;
      pc2re = c2re;
      pc2im = c2im;

      const double t = mu + ((double)SPS + adj);
      const double tfl = floor(t);
      pos += (Py_ssize_t)tfl;
      mu = t - tfl;
      ++emitted;
      ++n_sym;
    }

    st[0] = mu;
    st[1] = ph1;
    st[2] = ph2;
    st[3] = foff;
    st[4] = tfreq;
    st[5] = pc1re;
    st[6] = pc1im;
    st[7] = pc2re;
    st[8] = pc2im;
  }
  Py_END_ALLOW_THREADS

  memcpy(PyBytes_AS_STRING(st_b), st, sizeof(st));
  PyBuffer_Release(&in);
  PyBuffer_Release(&stb);
  PyBuffer_Release(&prm);
  PyObject *res =
      Py_BuildValue("(NlNn)", soft_b, n_sym, st_b, (Py_ssize_t)pos);
  return res;
}

static PyMethodDef methods[] = {
    {"track_block", track_block, METH_VARARGS,
     "serial AFC/TED symbol-tracking loop over one IQ block"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_tracking",
                                 "native symbol-tracking runtime", -1,
                                 methods};

PyMODINIT_FUNC PyInit__tracking(void) { return PyModule_Create(&mod); }
