"""Host seconds of the warm-up calls before the capture of the cell's
compiled step (step_graph.GraphedStep: each from its start to the next
call's, its backward included under a gradient), from the program's
set-up spans (transit_tpu_torch.utils.log.SETUP); None for a program
that keeps none."""


def read(ctx):
    try:
        from transit_tpu_torch.utils import log
    except ImportError:
        return None
    setup = getattr(log, "SETUP", None)
    if not setup:
        return None
    return sum(s for key, spans in setup.items() if key[0] == "make_forward"
               for name, s in spans if name == "warmup")
