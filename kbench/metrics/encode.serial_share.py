"""Share of the coupled-array encode's insert attempts that the card's
encoder decided one by one, in order: the k-mers of a batch that share a
probe position with an earlier k-mer of the batch.  100 x the program's
counters `encode.serial_attempts` over `encode.attempts`, summed over the
window's builds (`PipelineStats.counters`); nothing where the arrays were
encoded on the host.  It says whether the batch suits the arrays' size."""

UNIT = "%"
LAYER = "host encode: model/kmodel.py and the native encoder"
MOVES = "build_mreads_per_s"


def read(ctx):
    def total(name):
        return sum(getattr(s, "counters", {}).get(name, 0) for s in ctx.stats)

    attempts = total("encode.attempts")
    if not attempts:
        return None
    return 100.0 * total("encode.serial_attempts") / attempts
