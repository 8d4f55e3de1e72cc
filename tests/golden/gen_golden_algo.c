/* Golden-KAT generator for the ALGORITHM layer (VERDICT r3 #3): drives the
 * UNMODIFIED reference sources (/root/reference/src, -DSUPERCOP surf
 * stream) through the reference's own he-algo.c compositions at the
 * reference DEFAULT parameters (ref: tests/gpqhe.c:1296-1322) and dumps
 * decoded outputs as JSON.  tests/test_golden_algo.py replays the
 * identical surf-consumption order on the JAX engine.
 *
 * Three modes (separate binary runs => separate fresh surf streams):
 *
 *   linear     logn=14 logq=438 slots=16 Delta=2^50
 *              keypair -> genrlk -> genck -> genrk(16 keys)
 *              -> sample v[16] -> sample A[256] -> ct=enc_pk(ecd(v))
 *              -> gemv / sum / idx(1) / nrm2  (each on a fresh copy)
 *   nonlinear  logn=14 logq=438 slots=4 Delta=2^30 iter=5 (sqrt 6)
 *              keypair -> genrlk -> sample m0[4]
 *              -> enc inputs in order inv,exp,sigmoid,log,sqrt
 *              -> he_inv / he_exp / he_sigmoid / he_log / he_sqrt
 *   cmp        logn=15 logq=881 slots=4 Delta=2^30 iter=5 alpha=2
 *              keypair -> genrlk -> sample m0 TWICE (ref: tests/gpqhe.c
 *              test_cmp:1041-1042) -> enc(ma), enc(mb) -> he_cmp
 *
 * NOT generated (documented latent reference bugs, unusable as oracles):
 *   - rlsin: the test passes _Complex double a=2*pi*I/Delta to he_rlsin's
 *     double parameter (ref: tests/gpqhe.c:1166,1187); C discards the
 *     imaginary part, so a==0.0 and b=1/(2*I*a) is a division by zero.
 *   - coeff2slot: he_const_pt(&pt, 1/n) is integer division == 0
 *     (ref: src/he-bootstrap.c:385-386), zeroing the output; the test is
 *     also unreachable with valid params (no param-table entry,
 *     ref: tests/gpqhe.c:1284-1322).
 *
 * Build: tests/golden/generate.sh.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <complex.h>

#include "config.h"
#include "gpqhe.h"

extern void sample_z01vec(_Complex double vec[], const unsigned int m);

static void dump(FILE *f, const char *name, const _Complex double *m,
                 unsigned int slots, int *first)
{
  if (!*first) fprintf(f, ",\n");
  *first = 0;
  fprintf(f, "  \"%s\": [", name);
  for (unsigned int i = 0; i < slots; i++)
    fprintf(f, "%s[%.17e, %.17e]", i ? ", " : "",
            creal(m[i]), cimag(m[i]));
  fprintf(f, "]");
}

static MPI q_of(unsigned int logq)
{
  MPI q = gcry_mpi_set_ui(NULL, 1);
  gcry_mpi_lshift(q, q, logq);
  return q;
}

static void mode_linear(FILE *f)
{
  const unsigned int logn = 14, slots = 16;
  hectx_init(logn, q_of(438), slots, 1ULL << 50);

  poly_mpi_t sk;  he_pk_t pk;
  he_alloc_sk(&sk); he_alloc_pk(&pk);
  he_keypair(&pk, &sk);
  he_evk_t rlk, ck;
  he_alloc_evk(&rlk); he_alloc_evk(&ck);
  he_genrlk(&rlk, &sk);
  he_genck(&ck, &sk);
  he_evk_t *rk = malloc(slots * sizeof(he_evk_t));
  for (unsigned int i = 0; i < slots; i++) he_alloc_evk(&rk[i]);
  he_genrk(rk, &sk);
  fprintf(stderr, "linear: keys ready\n");

  _Complex double v[16], A[256], m[16];
  sample_z01vec(v, slots);
  sample_z01vec(A, slots * slots);

  he_pt_t pt;  he_alloc_pt(&pt);
  he_ct_t ct, in, out;
  he_alloc_ct(&ct); he_alloc_ct(&in); he_alloc_ct(&out);
  he_ecd(&pt, v);
  he_enc_pk(&ct, &pt, &pk);

  int first = 1;
  fprintf(f, "{\n");
  dump(f, "v", v, slots, &first);
  dump(f, "A", A, slots * slots, &first);

  he_copy_ct(&in, &ct);
  he_gemv(&out, A, &in, rk);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "gemv", m, slots, &first);
  fprintf(stderr, "linear: gemv done\n");

  he_copy_ct(&in, &ct);
  he_sum(&out, &in, rk);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "sum", m, slots, &first);
  fprintf(stderr, "linear: sum done\n");

  he_copy_ct(&in, &ct);
  he_idx(&out, &in, 1, rk);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "idx1", m, slots, &first);
  fprintf(stderr, "linear: idx done\n");

  he_copy_ct(&in, &ct);
  he_nrm2(&out, &in, &rlk, &ck, rk);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "nrm2", m, slots, &first);
  fprintf(stderr, "linear: nrm2 done\n");

  fprintf(f, "\n}\n");
}

static void mode_nonlinear(FILE *f)
{
  const unsigned int logn = 14, slots = 4, iter = 5;
  hectx_init(logn, q_of(438), slots, 1ULL << 30);

  poly_mpi_t sk;  he_pk_t pk;
  he_alloc_sk(&sk); he_alloc_pk(&pk);
  he_keypair(&pk, &sk);
  he_evk_t rlk;
  he_alloc_evk(&rlk);
  he_genrlk(&rlk, &sk);
  fprintf(stderr, "nonlinear: keys ready\n");

  _Complex double m0[4], m[4];
  sample_z01vec(m0, slots);

  /* derived inputs, exactly the reference tests' transformations */
  _Complex double a = 2 * GPQHE_PI * I / (double)(1ULL << 30);
  _Complex double mi[4], me[4], ms[4], ml[4], mq[4];
  for (unsigned int i = 0; i < slots; i++) {
    mi[i] = creal(m0[i]) + 0.5;          /* inv     (tests/gpqhe.c:849)  */
    me[i] = m0[i] * a;                   /* exp     (tests/gpqhe.c:901)  */
    ms[i] = m0[i] / 10;                  /* sigmoid (tests/gpqhe.c:952)  */
    ml[i] = creal(m0[i]) / 100000;       /* log     (tests/gpqhe.c:992)  */
    mq[i] = creal(m0[i]);                /* sqrt    (tests/gpqhe.c:1211) */
  }

  he_pt_t pt;  he_alloc_pt(&pt);
  he_ct_t ct_i, ct_e, ct_s, ct_l, ct_q, out;
  he_alloc_ct(&ct_i); he_alloc_ct(&ct_e); he_alloc_ct(&ct_s);
  he_alloc_ct(&ct_l); he_alloc_ct(&ct_q); he_alloc_ct(&out);
  he_ecd(&pt, mi); he_enc_pk(&ct_i, &pt, &pk);
  he_ecd(&pt, me); he_enc_pk(&ct_e, &pt, &pk);
  he_ecd(&pt, ms); he_enc_pk(&ct_s, &pt, &pk);
  he_ecd(&pt, ml); he_enc_pk(&ct_l, &pt, &pk);
  he_ecd(&pt, mq); he_enc_pk(&ct_q, &pt, &pk);

  int first = 1;
  fprintf(f, "{\n");
  dump(f, "m0", m0, slots, &first);

  he_inv(&out, &ct_i, &rlk, iter);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "inv", m, slots, &first);
  fprintf(stderr, "nonlinear: inv done\n");

  he_exp(&out, a, &ct_e, &rlk, iter);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "exp", m, slots, &first);
  fprintf(stderr, "nonlinear: exp done\n");

  he_sigmoid(&out, &ct_s, &rlk);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "sigmoid", m, slots, &first);
  fprintf(stderr, "nonlinear: sigmoid done\n");

  he_log(&out, &ct_l, &rlk);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "log", m, slots, &first);
  fprintf(stderr, "nonlinear: log done\n");

  he_sqrt(&out, &ct_q, &rlk, iter + 1);   /* sqrt iter=6, tests/gpqhe.c:1314 */
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "sqrt", m, slots, &first);
  fprintf(stderr, "nonlinear: sqrt done\n");

  fprintf(f, "\n}\n");
}

static void mode_cmp(FILE *f)
{
  const unsigned int logn = 15, slots = 4, iter = 5, alpha = 2;
  hectx_init(logn, q_of(881), slots, 1ULL << 30);

  poly_mpi_t sk;  he_pk_t pk;
  he_alloc_sk(&sk); he_alloc_pk(&pk);
  he_keypair(&pk, &sk);
  he_evk_t rlk;
  he_alloc_evk(&rlk);
  he_genrlk(&rlk, &sk);
  fprintf(stderr, "cmp: keys ready\n");

  _Complex double m0[4], ma[4], mb[4], m[4];
  sample_z01vec(m0, slots);
  sample_z01vec(m0, slots);   /* sampled twice, ref: tests/gpqhe.c:1041-1042 */
  for (unsigned int i = 0; i < slots; i++) {
    ma[i] = creal(m0[i]) + 0.5;
    mb[i] = cimag(m0[i]) + 0.5;
  }

  he_pt_t pt;  he_alloc_pt(&pt);
  he_ct_t ct1, ct2, out;
  he_alloc_ct(&ct1); he_alloc_ct(&ct2); he_alloc_ct(&out);
  he_ecd(&pt, ma); he_enc_pk(&ct1, &pt, &pk);
  he_ecd(&pt, mb); he_enc_pk(&ct2, &pt, &pk);

  int first = 1;
  fprintf(f, "{\n");
  dump(f, "m0", m0, slots, &first);

  he_cmp(&out, &ct1, &ct2, &rlk, iter, alpha);
  he_dec(&pt, &out, &sk); he_dcd(m, &pt);
  dump(f, "cmp", m, slots, &first);
  fprintf(stderr, "cmp: done\n");

  fprintf(f, "\n}\n");
}

int main(int argc, char **argv)
{
  if (argc < 3) {
    fprintf(stderr, "usage: %s [linear|nonlinear|cmp] out.json\n", argv[0]);
    return 1;
  }
  gcry_check_version(NULL);
  FILE *f = fopen(argv[2], "w");
  if (!strcmp(argv[1], "linear")) mode_linear(f);
  else if (!strcmp(argv[1], "nonlinear")) mode_nonlinear(f);
  else if (!strcmp(argv[1], "cmp")) mode_cmp(f);
  else { fprintf(stderr, "unknown mode %s\n", argv[1]); return 1; }
  fclose(f);
  fprintf(stderr, "golden written to %s\n", argv[2]);
  return 0;
}
