"""The two-rank gloo pool shared by a test module (a module-scoped
fixture): its ranks meet through a FileStore under the module's temporary
directory, with no fixed port, and every job has a 60 s timeout, so a
stuck rank fails its test instead of hanging the run."""
import os

import pytest

WORLD = 2


def make_pool_fixture():
    @pytest.fixture(scope="module")
    def pool(tmp_path_factory):
        from paddle_tpu_torch.distributed.spawn import RankPool
        store = os.path.join(str(tmp_path_factory.mktemp("ranks")), "store")
        p = RankPool(WORLD, store, backend="gloo", timeout_s=60.0,
                     env={"OMP_NUM_THREADS": "1"})
        yield p
        p.close()
    return pool
