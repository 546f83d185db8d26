"""MLA decode's attention over the expanded cache: the device time of the
kernels launched inside the ``mla.attend`` spans (the plain attention and
its fp32 copies of q and k) in the traced batches, over their decode steps
(``serve.decode_step`` spans), in ms."""

from perfbench import spans


def read(run):
    return spans.per(run, lambda t: spans.device_s(t, "mla.attend"),
                     ("serve.decode_step",))
