"""The share of its roofline that `repro_torch::flash_attention` reached in the
traced batches (`perfbench.roofline.share`), in %."""

from perfbench import roofline


def read(run):
    return roofline.share(run, "repro_torch::flash_attention")
