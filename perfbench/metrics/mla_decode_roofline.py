"""The share of its roofline that `repro_torch::mla_decode` reached in the
traced batches (`perfbench.roofline.share`), in %: each row's live cache
slots, q and the output moved once over HBM's rate, against the device
time of the kernel and its combine.  None where no decode step took the
latent route."""

from perfbench import roofline


def read(run):
    return roofline.share(run, "repro_torch::mla_decode")
