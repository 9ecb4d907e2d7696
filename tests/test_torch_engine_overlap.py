"""The engine's producer loop with one snapshot in flight, on the CPU.

At a batch end the engine enqueues the snapshot (render, copy to host
buffers) and finishes it (wait, rebuild, pack, push) only after the next
batch's steps were enqueued; a pause, a reconfigure, the end, an error and a
stop finish it first. These tests hold every frame, its step and its
positions to a World stepped to the same update by hand, and the queue's
accounting to that of a loop that pushes each snapshot at once.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.scenarios import uniform_disc
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops.raster import (render_frame,
                                                   render_frame_sparse,
                                                   sparse_to_frame)
from nbody_simulation_tpu_torch.runtime.engine import Engine, Snapshot

torch.set_num_threads(min(2, torch.get_num_threads()))

N = 256


def _world(render_size: int = 100) -> World:
    return World(uniform_disc(N, seed=7),
                 SimConfig(force_path="direct", render_size=render_size))


def _expected(steps, render_size: int):
    """``{step: (frame, pos)}`` of a World stepped by hand."""
    twin, out = _world(), {}
    for step in sorted(set(steps)):
        twin.run(step - twin.updates)
        st = twin.state
        frame = render_frame(st.pos, st.vel, st.mass,
                             world_size=twin.config.world_size,
                             render_size=render_size,
                             heavy_weight=twin.config.heavy_weight).numpy()
        out[step] = frame, st.pos[:st.n_real].numpy().copy()
    return out


def _drain(queue) -> list[Snapshot]:
    snaps = []
    while (data := queue.pop(0.0)) is not None:
        snaps.append(Snapshot.unpack(data))
    return snaps


def _check_counts(eng: Engine) -> None:
    c = eng.snapshot_counts
    assert c.overlapped + c.flushed == eng.pushed + eng.dropped
    assert c.wait_s >= 0.0 and c.pack_s > 0.0


# 100² pixels take the sparse encoding at N=256, 12² the dense frame.
@pytest.mark.parametrize("render_size", [100, 12])
@pytest.mark.parametrize("include_particles", [False, True])
def test_frames_are_those_of_the_states_in_step_order(render_size,
                                                      include_particles):
    eng = Engine(_world(render_size), queue_depth=16, steps_per_snapshot=3,
                 snapshot_interval=0.0, include_particles=include_particles)
    eng.start(max_steps=12)
    eng.join(timeout=60)
    eng.stop()
    assert not eng._thread.is_alive()
    snaps = _drain(eng.queue)
    # Each batch end, then the end state once more; the last is the final.
    assert [s.step for s in snaps] == [3, 6, 9, 12, 12]
    want = _expected([s.step for s in snaps], render_size)
    for s in snaps:
        np.testing.assert_array_equal(s.frame, want[s.step][0])
        if include_particles:
            np.testing.assert_array_equal(s.pos, want[s.step][1])
        else:
            assert s.pos is None
    c = eng.snapshot_counts
    assert (c.overlapped, c.flushed) == (3, 2) and eng.dropped == 0
    _check_counts(eng)


def test_sparse_encoding_is_the_dense_frame():
    st = _world().state
    kw = dict(world_size=1e5, render_size=100, heavy_weight=10.0)
    np.testing.assert_array_equal(
        sparse_to_frame(*render_frame_sparse(st.pos, st.vel, st.mass,
                                             cap=N, **kw), 100),
        render_frame(st.pos, st.vel, st.mass, **kw).numpy())


def test_render_size_reconfigure_flushes_into_the_old_queue():
    """The snapshot of step 6 was rendered at 100² before the reconfigure
    asked at that batch took effect: it goes into the old queue, and every
    later frame is 50²."""
    old = []

    def hook(world):
        if world.updates == 6:
            old.append(eng.queue)
            eng.reconfigure(render_size=50)

    eng = Engine(_world(), queue_depth=16, steps_per_snapshot=3,
                 snapshot_interval=0.0, on_batch=hook)
    eng.start(max_steps=12)
    eng.join(timeout=60)
    eng.stop()
    before, after = _drain(old[0]), _drain(eng.queue)
    assert [s.step for s in before] == [3, 6]
    assert [s.step for s in after] == [9, 12, 12]
    for snaps, size in ((before, 100), (after, 50)):
        want = _expected([s.step for s in snaps], size)
        for s in snaps:
            np.testing.assert_array_equal(s.frame, want[s.step][0])
    assert eng.dropped == 0 and eng.snapshot_counts.flushed == 3
    _check_counts(eng)


def test_pause_flushes_before_its_own_frames():
    """Paused at step 6: the batch's own snapshot comes out first, then the
    paused loop's frames of the same state, then the steps go on."""
    def hook(world):
        if world.updates == 6:
            eng.pause()

    eng = Engine(_world(), queue_depth=64, steps_per_snapshot=3,
                 snapshot_interval=0.0, on_batch=hook)
    eng.start(max_steps=12)
    try:
        deadline = time.monotonic() + 30
        while eng.pushed < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.paused and eng.world.updates == 6 and eng.pushed >= 3
        eng.resume()
        eng.join(timeout=60)
        assert not eng._thread.is_alive()
    finally:
        eng.stop()
    snaps = _drain(eng.queue)
    steps = [s.step for s in snaps]
    paused = len(steps) - 5
    assert paused >= 1 and steps == [3, 6] + [6] * paused + [9, 12, 12]
    want = _expected(steps, 100)
    for s in snaps:
        np.testing.assert_array_equal(s.frame, want[s.step][0])
    assert eng.snapshot_counts.overlapped == 2
    _check_counts(eng)


def test_pause_pushes_the_snapshot_in_flight_at_once():
    """With an interval no paused frame reaches, the only frame of step 3
    is the batch's own, pushed as the pause takes effect, not when the
    engine resumes."""
    def hook(world):
        if world.updates == 3:
            eng.pause()

    eng = Engine(_world(), queue_depth=16, steps_per_snapshot=3,
                 snapshot_interval=1000.0, on_batch=hook)
    eng.start(max_steps=12)
    try:
        deadline = time.monotonic() + 10
        while eng.pushed < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.paused and eng.world.updates == 3 and eng.pushed == 1
        eng.resume()
        eng.join(timeout=60)
    finally:
        eng.stop()
    assert [s.step for s in _drain(eng.queue)] == [3, 12]
    _check_counts(eng)


def _synchronous_accounting(capacity: int, batches: int, spb: int):
    """What a loop that renders and pushes at each batch end leaves with a
    consumer that never pops: a snapshot whenever the queue has room, and
    the end state in place of the oldest."""
    queue, pushed = [], 0
    for b in range(1, batches + 1):
        if len(queue) < capacity:
            queue.append(b * spb)
            pushed += 1
    if len(queue) == capacity:
        queue.pop(0)
    queue.append(batches * spb)
    return queue, pushed + 1, 0


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_dropped_as_the_synchronous_loop_with_a_stalled_consumer(capacity):
    eng = Engine(_world(), queue_depth=capacity, steps_per_snapshot=2,
                 snapshot_interval=0.0)
    eng.start(max_steps=14)
    eng.join(timeout=60)
    eng.stop()
    queue, pushed, dropped = _synchronous_accounting(capacity, 7, 2)
    assert (eng.pushed, eng.dropped) == (pushed, dropped)
    assert [s.step for s in _drain(eng.queue)] == queue
    _check_counts(eng)


def test_an_error_flushes_the_snapshot_in_flight():
    world = _world()
    run = world.run

    def failing(n):
        if world.updates >= 6:
            raise RuntimeError("lost the device")
        run(n)

    world.run = failing
    eng = Engine(world, queue_depth=16, steps_per_snapshot=3,
                 snapshot_interval=0.0)
    eng.start(max_steps=12)
    eng.join(timeout=60)
    with pytest.raises(RuntimeError, match="lost the device"):
        eng.stop()
    # Step 6's snapshot was in flight when the third batch failed.
    assert [s.step for s in _drain(eng.queue)] == [3, 6]
    assert eng.snapshot_counts.flushed == 1
    _check_counts(eng)


def test_stop_flushes_then_pushes_the_end_state():
    """A stop from another thread while batches run: every frame in step
    order, the last one the state the World stopped at."""
    eng = Engine(_world(), queue_depth=2, steps_per_snapshot=1,
                 snapshot_interval=0.0)
    got = []

    def consume():
        while (snap := eng.next_snapshot(timeout=30)) is not None:
            got.append(snap)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    eng.start()
    deadline = time.monotonic() + 30
    while len(got) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    eng.stop()
    consumer.join(timeout=30)
    assert not consumer.is_alive()
    steps = [s.step for s in got]
    assert len(steps) >= 5 and steps == sorted(steps)
    assert steps[-1] == eng.world.updates
    want = _expected([steps[0], steps[-1]], 100)
    for s in (got[0], got[-1]):
        np.testing.assert_array_equal(s.frame, want[s.step][0])
    _check_counts(eng)
