/* Demo program over the C API, the analog of the reference
 * trac_fortran.f90 demo: create a simulation from a task dir, step it
 * to completion, print final parcel positions.  The KEY VALUE tail goes
 * to mptrac_c_create (with --device cuda|cpu, --dtype float64|float32). */

#include <stdio.h>
#include <stdlib.h>

#include "mptrac_c.h"

int main(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr,
            "usage: demo_trac <dirname> <ctl> <atm_in> [KEY VALUE ...]\n");
    return 1;
  }
  if (mptrac_c_start() < 0)
    return 1;
  int h = mptrac_c_create(argv[1], argv[2], argv[3], argc - 4,
                          (const char **) (argv + 4));
  if (h < 0)
    return 1;
  printf("time range: %.0f .. %.0f s\n", mptrac_c_t_start(h),
         mptrac_c_t_stop(h));
  int steps = 0, rc;
  while ((rc = mptrac_c_step(h, 1)) > 0)
    steps++;
  if (rc < 0)
    return 1;
  int n = mptrac_c_n_parcels(h);
  printf("done: %d steps, %d parcels at t=%.0f\n", steps, n,
         mptrac_c_time(h));
  int cap = n < 5 ? n : 5;
  double *lon = malloc(sizeof(double) * (size_t) cap);
  double *lat = malloc(sizeof(double) * (size_t) cap);
  double *p = malloc(sizeof(double) * (size_t) cap);
  int got = mptrac_c_get_positions(h, lon, lat, p, cap);
  for (int i = 0; i < got; i++)
    printf("parcel %d: lon=%.4f lat=%.4f p=%.2f\n", i, lon[i], lat[i],
           p[i]);
  free(lon);
  free(lat);
  free(p);
  mptrac_c_destroy(h);
  mptrac_c_finish();
  return 0;
}
