"""Device memory of the chunk indexes held during a sweep (counter
`chunked.index_bytes`, added once a block's sweep is launched), over the
blocks swept (their `chunked.merge` spans), in GiB: every chunk's
tensors when the index is resident.  Nothing where the program has no
such counter or no block was merged."""


def read(ctx):
    try:
        from biokanga_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    blocks = ctx["trace"].host_calls.get("chunked.merge")
    b = counts().get("chunked.index_bytes")
    if not blocks or b is None:
        return None
    return b / blocks / 2**30
