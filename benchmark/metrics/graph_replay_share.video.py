"""graph_replay_share.video: ``replays.graph_replay_share`` in the bf16 video cell."""

from benchmark.replays import graph_replay_share as read  # noqa: F401
