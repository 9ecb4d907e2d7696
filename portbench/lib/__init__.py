"""The harness's shared parts: the manifest, the generators, the
reference, the checks, the trace and roofline arithmetic."""
