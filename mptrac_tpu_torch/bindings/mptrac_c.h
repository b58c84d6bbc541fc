/* C API for the mptrac_tpu_torch package (PyTorch + CUDA).
 *
 * Foreign-language entry points mirroring the reference library's
 * public surface (mptrac_read_ctl / read_atm / init / get_met /
 * run_timestep / write_atm / free: the reference's mptrac.h and the
 * Fortran wrapper mptrac_fortran.f90).  The implementation embeds
 * CPython and drives mptrac_tpu_torch.capi; simulations run on the GPU
 * unless the KEY VALUE list of mptrac_c_create holds "--device cpu"
 * ("--dtype float32" for the kernels' compute mode).
 *
 * Usage:
 *   mptrac_c_start();
 *   int h = mptrac_c_create("task1", "trac.ctl", "atm_init.tab",
 *                           0, NULL);
 *   while (mptrac_c_step(h, 1)) { ... }       // or mptrac_c_run(h, 1)
 *   mptrac_c_destroy(h);
 *   mptrac_c_finish();
 *
 * All functions return <0 on error (Python exception; printed to
 * stderr).  Thread safety: call from one thread only.
 */

#ifndef MPTRAC_C_H
#define MPTRAC_C_H

#ifdef __cplusplus
extern "C" {
#endif

/* Start/stop the embedded interpreter. */
int mptrac_c_start(void);
void mptrac_c_finish(void);

/* Create a simulation from a task directory, control file and
 * particle file (+ optional KEY VALUE override pairs).  Returns a
 * handle >0, or <0 on error. */
int mptrac_c_create(const char *dirname, const char *ctl_file,
                    const char *atm_file, int nargs, const char **args);

/* Model time range and current time (seconds since 2000-01-01). */
double mptrac_c_t_start(int handle);
double mptrac_c_t_stop(int handle);
double mptrac_c_time(int handle);

/* Advance one timestep; returns 1 while stepping, 0 at the end,
 * <0 on error.  write_output != 0 enables the output subsystem. */
int mptrac_c_step(int handle, int write_output);

/* Run the remaining time loop to completion. */
int mptrac_c_run(int handle, int write_output);

/* Number of active parcels. */
int mptrac_c_n_parcels(int handle);

/* Copy parcel positions into caller buffers of capacity cap;
 * returns the count written. */
int mptrac_c_get_positions(int handle, double *lon, double *lat,
                           double *p, int cap);

/* Write the current particle state to a file (format by ctl). */
int mptrac_c_write_atm(int handle, const char *path);

/* Release a simulation. */
int mptrac_c_destroy(int handle);

#ifdef __cplusplus
}
#endif

#endif /* MPTRAC_C_H */
