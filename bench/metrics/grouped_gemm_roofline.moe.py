"""grouped_gemm_roofline.moe: The grouped GEMM kernels' share of their
bound in the profiled train() calls: the least time of the launches a
call makes (``bench/kinds/moe.grouped_gemm_launches`` at the cell's
shapes and the dispatch blocks' capacities, each launch the larger of its
bytes at 3.35 TB/s and its operations at 495 TFLOP/s) over the device
time of the kernels whose name holds ``grouped_gemm``.  Raises where the
profile's launches are not the program's count a call
(``moe/grouped_gemm_launches`` in the calls that timed spans) times the
profiled calls.

A reader is handed the run and not its cell, so this one holds
``CELL``'s shapes; it raises unless the running cell's model FLOPs a call
are what ``CELL``'s configuration and traffic give at the run's layout
(the ``block_exec`` spans' members), so that another MoE cell that lists
it fails rather than reads a wrong bound."""
from bench import counts, manifest
from bench.kinds import moe

CELL = "granite_moe.fl14_kd"
LAYER = "kernel: kernels/grouped_gemm"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"
KERNEL = "grouped_gemm"


def read(run):
    prof = run.profile
    if prof is None or not run.calls:
        return None
    names = [n for n in prof["by_op"] if KERNEL in n]
    launches = sum(prof["count_by_op"][n] for n in names)
    if launches == 0:
        return None
    # the calls run prof, ..., prof, ranges, spans, ...: the profiled
    # calls are those before the ranges call
    n_prof = min(run.calls) - 1
    per_call = run.counters.get("moe/grouped_gemm_launches", 0) \
        / len(run.calls)
    if launches != per_call * n_prof:
        raise ValueError(f"{launches} {KERNEL} launches in {n_prof} "
                         f"profiled calls; the program counts {per_call} "
                         "a call")
    cell = manifest.cell(CELL)
    blocks = [e["args"] for e in run.port_events if e["name"] == "block_exec"]
    capacity = {b["level"]: b["capacity"] for b in blocks}
    members = dict(sorted((b["level"], b["members"]) for b in blocks))
    flops = moe.flops_per_call(cell["config"], cell["traffic"], members,
                               cell["traffic"]["test_windows"])
    if flops != run.flops_per_call:
        raise ValueError(f"{CELL}'s shapes give {flops} model FLOPs a call "
                         f"at this layout, the running cell "
                         f"{run.flops_per_call}: this reader reads {CELL} "
                         "alone")
    work = moe.grouped_gemm_launches(cell["config"], cell["traffic"],
                                     capacity, cell["traffic"]["test_windows"])
    if sum(n for n, _, _ in work) != per_call:
        raise ValueError(f"the program counts {per_call} {KERNEL} launches "
                         f"a call; the benchmark's count of its work "
                         f"{sum(n for n, _, _ in work)}")
    b_ms = sum(n * counts.bound_ms(nbytes, ops)[0] for n, nbytes, ops in work)
    t_ms = sum(prof["by_op"][n] for n in names) * 1e3
    return 100.0 * b_ms * n_prof / t_ms
