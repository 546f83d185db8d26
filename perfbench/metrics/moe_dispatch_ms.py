"""The MoE's dispatch: the device time of the kernels launched inside the
``moe.route`` and ``moe.combine`` spans (the router, the capacity sort and
the scatter into expert slots; the weighted gather back) in the traced
batches, over their forwards (``serve.prefill`` and ``serve.decode_step``
spans), in ms."""

from perfbench import spans


def read(run):
    return spans.per(run, lambda t: spans.device_s(t, "moe.route",
                                                   "moe.combine"))
