/* Golden-KAT generator: drives the UNMODIFIED reference sources
 * (/root/reference/src, compiled with -DSUPERCOP so every byte of
 * randomness comes from the deterministic surf stream, ref:
 * src/rng.c:36-77, README.md:48) through one fixed op sequence and dumps
 * the DECODED outputs as JSON.  The frozen output (golden_logn11.json)
 * is diffed against the JAX engine replaying the identical surf
 * consumption order in tests/test_golden.py — the one check that would
 * catch a systematic error shared by the engine and its python-int
 * oracle (VERDICT r2 #4).
 *
 * Sequence (must match tests/test_golden.py exactly):
 *   hectx_init(logn=11, q=2^48, slots=4, Delta=2^20)
 *   keypair -> genrlk -> genck -> genrk (slots keys, rot order 0..3)
 *   m0 = sample_z01vec; ct1 = enc_pk(ecd(m0))
 *   m1 = sample_z01vec; ct2 = enc_pk(ecd(m1))
 *   outputs (each decoded after he_dec with sk):
 *     "enc"     dcd(dec(ct1))
 *     "add"     dcd(dec(ct1 + ct2))
 *     "mulrs"   dcd(dec(rs(mul(ct1, ct2, rlk))))
 *     "conj"    dcd(dec(conj(ct1, ck)))
 *     "rot1"    dcd(dec(rot(ct1, 1, rk)))
 *     "moddown" dcd(dec(moddown(ct1)))
 *
 * Build: tests/golden/generate.sh (gcc + the system libgcrypt.so.20 via
 * the declaration-only gcrypt.h in this directory).
 */

#include <stdio.h>
#include <stdlib.h>
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

int main(int argc, char **argv)
{
  if (argc < 2) { fprintf(stderr, "usage: %s out.json\n", argv[0]); return 1; }
  const unsigned int logn = 11, logq = 48, slots = 4;
  const uint64_t Delta = 1ULL << 20;
  gcry_check_version(NULL);

  MPI q = gcry_mpi_set_ui(NULL, 1);
  gcry_mpi_lshift(q, q, logq);
  hectx_init(logn, q, slots, Delta);

  poly_mpi_t sk;
  he_pk_t pk;
  he_alloc_sk(&sk);
  he_alloc_pk(&pk);
  he_keypair(&pk, &sk);

  he_evk_t rlk, ck;
  he_alloc_evk(&rlk);
  he_alloc_evk(&ck);
  he_genrlk(&rlk, &sk);
  he_genck(&ck, &sk);
  he_evk_t *rk = malloc(slots * sizeof(he_evk_t));
  for (unsigned int i = 0; i < slots; i++)
    he_alloc_evk(&rk[i]);
  he_genrk(rk, &sk);

  _Complex double m0[4], m1[4], m[4];
  sample_z01vec(m0, slots);
  he_pt_t pt;
  he_alloc_pt(&pt);
  he_ecd(&pt, m0);
  he_ct_t ct1, ct2, out;
  he_alloc_ct(&ct1);
  he_alloc_ct(&ct2);
  he_alloc_ct(&out);
  he_enc_pk(&ct1, &pt, &pk);
  sample_z01vec(m1, slots);
  he_ecd(&pt, m1);
  he_enc_pk(&ct2, &pt, &pk);

  FILE *f = fopen(argv[1], "w");
  int first = 1;
  fprintf(f, "{\n");

  he_dec(&pt, &ct1, &sk);
  he_dcd(m, &pt);
  dump(f, "enc", m, slots, &first);

  he_add(&out, &ct1, &ct2);
  he_dec(&pt, &out, &sk);
  he_dcd(m, &pt);
  dump(f, "add", m, slots, &first);

  he_mul(&out, &ct1, &ct2, &rlk);
  he_rs(&out);
  he_dec(&pt, &out, &sk);
  he_dcd(m, &pt);
  dump(f, "mulrs", m, slots, &first);

  he_copy_ct(&out, &ct1);
  he_conj(&out, &ck);
  he_dec(&pt, &out, &sk);
  he_dcd(m, &pt);
  dump(f, "conj", m, slots, &first);

  he_copy_ct(&out, &ct1);
  he_rot(&out, 1, rk);
  he_dec(&pt, &out, &sk);
  he_dcd(m, &pt);
  dump(f, "rot1", m, slots, &first);

  he_copy_ct(&out, &ct1);
  he_moddown(&out);
  he_dec(&pt, &out, &sk);
  he_dcd(m, &pt);
  dump(f, "moddown", m, slots, &first);

  /* the raw sampled messages, so the replayer can pin stream parity */
  dump(f, "m0", m0, slots, &first);
  dump(f, "m1", m1, slots, &first);

  fprintf(f, "\n}\n");
  fclose(f);
  fprintf(stderr, "golden written to %s\n", argv[1]);
  return 0;
}
