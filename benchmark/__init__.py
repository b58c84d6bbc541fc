"""The benchmark of ``mptrac_tpu_torch`` (see README.md in this folder)."""
