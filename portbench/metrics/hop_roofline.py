"""The Wilson hops' share of their bandwidth roofline in a traced
stretch: the bytes of every hop launched there (``portbench.hopbytes``,
each launch counted at the kernel library's entry point) over the device
time of the hop kernels, over 3.35 TB/s, in %.  Nothing to read (no
trace, no hop, or a launch the byte model has no count for) gives None.
It reads every ``hop_roofline.<cell kind>`` entry, one for each
end-to-end metric that it moves."""

from portbench.hopbytes import HBM_BYTES_PER_S

# the port's hop kernels (csrc/dslash_ch.cuh): K1 / K1d / K1e / K3, K2 /
# K2d, and the t-local and box hops
HOP_KERNELS = ("dslash_ch_kernel", "dslash_ch_msrc_kernel",
               "dslash_ch_local_kernel", "dslash_ch_local_apbc_kernel",
               "dslash_ch_box_kernel")


def read(run):
    tr = run.trace
    if tr is None or tr["unknown_launches"]:
        return None
    nbytes = sum(tr["hop_bytes"].values())
    secs = sum(s for k, s in tr["kernels"].items()
               if any(n in k for n in HOP_KERNELS))
    if nbytes == 0 or secs == 0:
        return None
    return 100.0 * nbytes / (secs * HBM_BYTES_PER_S)
