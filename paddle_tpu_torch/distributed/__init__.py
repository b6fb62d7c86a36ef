"""Multi-process runtime: the process-group bootstrap and the launcher.

The parameter-server runtime (ps_server, rpc, sparse tables) waits for
ROADMAP §A8e.
"""
from .env import (init_parallel_env, global_mesh,  # noqa: F401
                  parallel_env_rank, parallel_env_world_size)
