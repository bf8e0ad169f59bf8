"""The share of the traced slice's forwards that ran as a CUDA graph's
replay, read from the program's host spans (``program_spans.analysis``):
the count of ``engine.replay`` spans over the count of ``engine.forward``
spans that start in the slice, in percent. A program that replays nothing
reads 0; a slice without ``engine.forward`` spans (or without spans at
all) reads None."""

from benchmark import program_spans

REPLAY = "engine.replay"


def graph_replay_share(run):
    a = program_spans.analysis(run)
    if a is None:
        return None
    names = a["names"]
    forwards = names.get(program_spans.FORWARD, {}).get("count", 0)
    if not forwards:
        return None
    return 100.0 * names.get(REPLAY, {}).get("count", 0) / forwards
