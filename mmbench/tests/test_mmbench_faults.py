"""The check catches a broken program: the harness's run without its look for a card (the
port's plain versions on the CPU, at a tiny size), the timed path broken underneath, and
``correct`` comes out false, once for each fault a cell can have:
- a step that returns its state unchanged (the decorators; the temporal blend);
- half of the batch left out (half of each area's chunks; half of each scene update);
- an answer altered where it is produced (one block of every chunk; one value of the frame).
The exchange between chips does not exist in a one-chip cell."""

from __future__ import annotations

import contextlib

import pytest
import torch

from mmbench.tests.rehearse_cpu import tiny_flyloop, tiny_pregen


def _correct(wl):
    wl.window()
    return all(v <= lim for _, v, lim in wl.check())


@pytest.fixture(scope="module")
def pregen_run():
    wl = tiny_pregen()
    wl.setup()
    return wl


@pytest.fixture(scope="module")
def fly_run():
    wl = tiny_flyloop(seconds=1.0)
    wl.setup()
    return wl


def _pregen_fault(name):
    from mega_minecraft_tpu_torch.terrain import pipeline

    area = pipeline._area

    if name == "state_unchanged":
        return _patched(pipeline.decorators, "place_decorators_batch", lambda blocks, *a: blocks)

    def broken(*args, **kw):
        out = area(*args, **kw)
        b = out["blocks"]
        if name == "half_left_out":
            b[b.shape[0] // 2:] = 0
        else:  # an answer altered: one block of every chunk
            b[:, 8, 8, 200] += 1
        return out

    return _patched(pipeline, "_area", broken)


@contextlib.contextmanager
def _patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def test_pregen_sound_run_is_correct(pregen_run):
    assert _correct(pregen_run)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_pregen_fault_is_caught(pregen_run, fault):
    with _pregen_fault(fault):
        assert not _correct(pregen_run)


def _fly_fault(name):
    from mega_minecraft_tpu_torch.app import engine

    if name == "state_unchanged":
        return _patched(engine.reproject, "accumulate_temporal", lambda fbs, *a: fbs)
    if name == "half_left_out":
        update = engine.brickmap.update_chunks

        def half(scene, d_blocks, slots, mask, *a):
            mask = mask.copy()
            mask[len(mask) // 2:] = False
            return update(scene, d_blocks, slots, mask, *a)

        return _patched(engine.brickmap, "update_chunks", half)
    present = engine.tonemap.present

    def altered(hdr):
        img = present(hdr)
        img[0, 0, 0] += 1
        return img

    return _patched(engine.tonemap, "present", altered)


def test_fly_sound_run_is_correct(fly_run):
    assert _correct(fly_run)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_fly_fault_is_caught(fly_run, fault):
    if fault == "half_left_out":
        # the scene update runs when chunks come into the scene: the upload after the drain
        eng = fly_run.eng
        eng.scene = eng.scene.__class__(torch.full_like(eng.scene.flat, _empty_word()), eng.scene.origin,
                                        eng.scene.dims)
        eng.scheduler.newly_filled.extend(p[:2] for p in fly_run._drawable())
    with _fly_fault(fault):
        assert not _correct(fly_run)
    fly_run.eng._upload_new_chunks()


def _empty_word():
    from mega_minecraft_tpu_torch.render import brickmap

    return brickmap.empty_field_word()
