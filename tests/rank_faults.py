"""A target for ``core.mesh.run_local_ranks`` that fails on one rank,
kept apart from the test modules so that a rank importing it loads only
the port's ``core.mesh`` (``tests/test_torch_local_ranks.py``)."""
from dynamorph_tpu_torch.core import mesh


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.process_index() == 1:
        raise ValueError("planted failure on rank one")
    mesh.barrier("never")
    return "unreachable"
