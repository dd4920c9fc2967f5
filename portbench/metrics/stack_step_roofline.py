"""``rt_stack_step`` (``csrc/stack_kernels.cu``, launched by
``ops/decoder_kernels.fused_stack_step``): the mean roofline time of one launch
over decode steps 0-126 at the cell's rows and memory length (portbench/work.py)
over its mean profiled device time per launch, in percent. Every launch runs
the loader's batch of rows: ``eval_model`` pads a ragged last batch to the
loader's batch size (``pad_host_batch``) before it decodes."""

from portbench import profiler, work


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    seconds, launches = profiler.kernel_time(prof, "stack_kernel")
    if not launches:
        return None
    cfg = ctx["cfg"]
    bound = work.stack_step_bound_s(ctx["traffic"]["batch"], work.memory_tokens(cfg), steps=ctx["steps"],
                                    dtype=cfg["compute_dtype"], c=cfg["hidden_dim"], heads=cfg["nheads"],
                                    f=cfg["dim_feedforward"], layers=cfg["dec_layers"])
    return 100.0 * bound / (seconds / launches)
