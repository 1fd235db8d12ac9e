"""Command-line tools of the port: the ULP probes (``ulp_check``,
``ulp_bisect``, ``ulp_smem``)."""
