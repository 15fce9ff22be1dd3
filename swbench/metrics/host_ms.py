"""The pipeline's host path, per search: the search's time on the host
clock less the kernel seconds the search itself returns (the program's own
timer: launches, kernels, the reorder on the card and the fetch), in ms.
What is left is the sort, the chunk plan, the profiles, the database's copy
and the pack's host side."""


def read(run):
    done = [s for s in run.searches if s.ok]
    if not done:
        return None
    return sum((s.end - s.start) - s.kernel_s for s in done) / len(done) * 1e3
