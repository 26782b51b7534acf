"""The plume's bits, pinned: the seeded start fields and one reference frame
in float64 (with the tiles its growth keeps) on the toy fixed, multigrid and
grown cells at one seed, held to values recorded on the tree before a
configuration could name its scene. Per-field sums and a few fixed lanes,
at a relative tolerance of 1e-12 (no hash: the last bits of a sum may differ
between CPUs)."""

import numpy as np
import pytest
import torch

import compare
import inputs
from reference import step
from reference import topology as rt

SEED = 2 ** 31 + 4242
REL = 1e-12
LANES = ((1, 0), (22, 255), (42, 110), (47, 300))  # (row, lane), active in every toy cell


def _field_readings(fields: dict) -> dict:
    """{field: [sum, sum of |values|, the values at LANES]}, in float64."""
    out = {}
    for k, v in fields.items():
        v = v.double()
        y = v[1] if k == "velocity" else v  # the jet's component
        out[k] = [float(v.sum()), float(v.abs().sum())] + [float(y[r, i]) for r, i in LANES]
    return out


def readings(cell) -> dict:
    """Every pinned number of one toy cell: the start's fields, the
    reference frame's fields and, grown, the kept tiles (active count,
    capacity, sum of their keys)."""
    tiles, cap = inputs.start_tiles(cell)
    rows = rt.build(tiles, cap)
    start = inputs.start_fields(cell, rows, SEED, "cpu")
    out = {"start": _field_readings(start)}
    topo = rt.with_index(rows, "cpu")
    sp, em = cell.solver(), cell.config["emitter"]
    levels = step.levels_for(topo, sp, torch.float64)
    stepped = step.frame(topo, compare.to64(start, "cpu"), sp, em, levels)
    if cell.traffic["topology"] == "grow":
        topo, stepped = step.grow(topo, stepped, em)
        keys = topo.keys[1:topo.n_active + 1].astype(np.int64)
        out["grown"] = {"tiles": [float(topo.n_active), float(topo.capacity), float(keys.sum())]}
    out["frame"] = _field_readings(stepped)
    return out


PINNED = {  # recorded on the parent tree of the scene seam
    "fixed": {
        "start": {
            "velocity": [
                42650.8635230449, 46444.13370354616, 0.05541383847594261, 5.723605155944824,
                0.13685058057308197, 0.005392138846218586],
            "temperature": [
                313769.87206029845, 313769.87206029845, 0.11893684417009354, 53.95878219604492,
                0.47635236382484436, 0.005605452228337526],
            "density": [
                3136.0778764093443, 3136.0778764093443, 0.00136285787448287, 0.5432554483413696,
                0.004286693409085274, 5.638202128466219e-05],
            "waste": [
                626.5331229357855, 626.5331229357855, 0.00035070927697233856, 0.12257388234138489,
                0.0010577311040833592, 9.032023626787122e-06],
            "fuel": [361.62132999300957, 361.62132999300957, 0.0, 0.5527543425559998, 0.0, 0.0],
            "flame": [360.40984132885933, 360.40984132885933, 0.0, 0.4011420011520386, 0.0, 0.0],
        },
        "frame": {
            "density": [
                3193.257314291747, 3193.257314291747, 0.0013533506106679716, 0.7538014941017949,
                0.004297724750415186, 5.638347148146166e-05],
            "flame": [705.1757149582587, 705.1757149582587, 0.0, 1.0, 0.0, 0.0],
            "fuel": [137.6458852184749, 137.6458852184749, 0.0, 0.227218612008605, 0.0, 0.0],
            "temperature": [
                379994.0361847312, 379994.0361847312, 0.11810714360042435, 150.16393305314728,
                0.47669994284340594, 0.005606508728400269],
            "waste": [
                1115.0778703041683, 1115.0778703041683, 0.00034826273747549366, 0.7727813879913951,
                0.0010575908186849967, 9.03444895305258e-06],
            "velocity": [
                50429.868215037946, 55322.982406156225, 0.05879808173125378, 12.433669584333996,
                0.1292702645446856, 0.004301048966935998],
        },
    },
    "mg": {
        "start": {
            "velocity": [
                42650.8635230449, 46444.13370354616, 0.05541383847594261, 5.723605155944824,
                0.13685058057308197, 0.005392138846218586],
            "temperature": [
                313769.87206029845, 313769.87206029845, 0.11893684417009354, 53.95878219604492,
                0.47635236382484436, 0.005605452228337526],
            "density": [
                3136.0778764093443, 3136.0778764093443, 0.00136285787448287, 0.5432554483413696,
                0.004286693409085274, 5.638202128466219e-05],
            "waste": [
                626.5331229357855, 626.5331229357855, 0.00035070927697233856, 0.12257388234138489,
                0.0010577311040833592, 9.032023626787122e-06],
            "fuel": [361.62132999300957, 361.62132999300957, 0.0, 0.5527543425559998, 0.0, 0.0],
            "flame": [360.40984132885933, 360.40984132885933, 0.0, 0.4011420011520386, 0.0, 0.0],
        },
        "frame": {
            "density": [
                3193.652707236571, 3193.652707236571, 0.001353382004953467, 0.7538051100024316,
                0.004303298039163581, 5.638668417768535e-05],
            "flame": [704.8936317700767, 704.8936317700767, 0.0, 1.0, 0.0, 0.0],
            "fuel": [137.58517426484516, 137.58517426484516, 0.0, 0.2269891472121359, 0.0, 0.0],
            "temperature": [
                380009.7283493602, 380009.7283493602, 0.1181098833851897, 150.16400407532834,
                0.4772106562186223, 0.005607103035575952],
            "waste": [
                1114.9733492239563, 1114.9733492239563, 0.0003482708162835436, 0.7730108527878641,
                0.0010581753130442266, 9.03575919183754e-06],
            "velocity": [
                50434.29900949224, 55534.8208662887, 0.058717498604452315, 12.407038264263617,
                0.12631915888655276, 0.004950766281457049],
        },
    },
    "grow": {
        "start": {
            "velocity": [
                7133.5857874155045, 7608.709898352623, 0.0, 9.023368835449219, 8.065840721130371,
                0.0],
            "temperature": [
                134165.091796875, 134165.091796875, 0.0, 152.2779998779297, 134.80567932128906,
                0.0],
            "density": [
                898.6771939992905, 898.6771939992905, 0.0, 1.1034431457519531, 1.015747308731079,
                0.0],
            "waste": [
                178.28697779774666, 178.28697779774666, 0.0, 0.17418600618839264,
                0.18349383771419525, 0.0],
            "fuel": [
                448.8837772011757, 448.8837772011757, 0.0, 0.45937150716781616, 0.4922529458999634,
                0.0],
            "flame": [
                450.8132148683071, 450.8132148683071, 0.0, 0.4463132321834564, 0.5417515635490417,
                0.0],
        },
        "grown": {
            "tiles": [264.0, 512.0, 142900265940.0],
        },
        "frame": {
            "density": [932.8608495826484, 932.8608495826484, 0.0, 0.0, 0.0, 0.0],
            "flame": [857.6164429988237, 857.6164429988237, 0.0, 0.0, 0.0, 0.0],
            "fuel": [246.15217709087347, 246.15217709087347, 0.0, 0.0, 0.0, 0.0],
            "temperature": [135066.607313575, 135066.607313575, 0.0, 0.0, 0.0, 0.0],
            "waste": [611.6590098429187, 611.6590098429187, 0.0, 0.0, 0.0, 0.0],
            "velocity": [
                11734.683000073626, 20599.882702851315, 0.0, 0.0, 0.0, 0.0026787885488521674],
        },
    },
}


@pytest.mark.parametrize("kind", ["fixed", "mg", "grow"])
def test_the_plume_start_and_reference_frame_are_pinned(toy, kind):
    got, want = readings(toy(kind)), PINNED[kind]
    assert {p: sorted(f) for p, f in got.items()} == {p: sorted(f) for p, f in want.items()}
    for part, fields in want.items():
        for name, values in fields.items():
            assert got[part][name] == pytest.approx(values, rel=REL, abs=0.0), (part, name)
