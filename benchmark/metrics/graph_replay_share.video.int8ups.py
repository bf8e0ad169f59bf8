"""graph_replay_share.video.int8ups: ``replays.graph_replay_share`` in the int8 ``ups`` video cell."""

from benchmark.replays import graph_replay_share as read  # noqa: F401
