"""The port's rank-swizzled chunk schedules against the JAX package's
(``lang/overlap.py``): ``chunk_at``, ``step_of``, ``schedule`` and
``ring_chunk`` are index logic and must be equal, exactly, for every mode
at each world size 1-8; the errors for an unknown mode and a ring
schedule of the wrong length are the same."""

import pytest

from triton_dist_tpu.lang import overlap as jov

from triton_dist_tpu_torch.lang import overlap

WORLDS = range(1, 9)


def test_modes_equal_jax():
    assert overlap.SWIZZLE_MODES == jov.SWIZZLE_MODES


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", jov.SWIZZLE_MODES)
def test_schedule_equals_jax(mode, world):
    for rank in range(world):
        for i in range(world):
            assert (overlap.chunk_at(i, rank, world, mode)
                    == jov.chunk_at(i, rank, world, mode))
            assert (overlap.step_of(i, rank, world, mode)
                    == jov.step_of(i, rank, world, mode))
            assert overlap.step_of(overlap.chunk_at(
                i, rank, world, mode), rank, world, mode) == i
        assert (overlap.schedule(rank, world, world, mode)
                == jov.schedule(rank, world, world, mode))
        assert sorted(overlap.schedule(rank, world, world, mode)) == \
            list(range(world))
    if mode == "identity":
        assert (overlap.schedule(0, world, world + 3, mode)
                == jov.schedule(0, world, world + 3, mode))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_chunk_equals_jax(world):
    for rank in range(world):
        for event in range(world):
            assert (overlap.ring_chunk(event, rank, world)
                    == jov.ring_chunk(event, rank, world))


@pytest.mark.parametrize("name,args", [("chunk_at", (0, 0, 4, "bogus")),
                                       ("step_of", (0, 0, 4, "bogus")),
                                       ("schedule", (0, 4, 3, "ag"))])
def test_errors_equal_jax(name, args):
    with pytest.raises(ValueError) as want:
        getattr(jov, name)(*args)
    with pytest.raises(ValueError) as got:
        getattr(overlap, name)(*args)
    assert str(got.value) == str(want.value)
