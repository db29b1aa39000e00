"""Model step: the share of the routed experts' weights that the decode
calls read over the traced sub-window -- experts read over experts that
could have been read, summed over every MoE layer of every routed decode
call -- from the program's counter (``ServeEngine.experts_read``, copied
where each server's tracing switches on and off), in %.  None for a
program without the counter, or one whose decode ran no routed layer."""


def read(run):
    fn = getattr(run.rec.eng, "experts_read", None)
    if fn is None or run.trace is None:
        return None
    got = fn()
    if not got or not got[1]:
        return None
    return 100.0 * got[0] / got[1]
