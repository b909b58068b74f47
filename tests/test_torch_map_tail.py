"""The map update's dense tail (ops/map_tail.py): one update's painted
cell sets applied in place, and the quads packed anew, only for the maps
whose gate fired.

On the CPU the wrapper runs its plain version, held bit for bit to the
chain it replaces (``apply_update``, the gate's ``torch.where``,
``quads_of`` of the chosen levels), the whole quads tensor included, its
wrap-around entries too; ungated maps keep their bits and their memory;
a gated cell's -0.0 turns to +0.0 as ``apply_update`` turns it; a
non-donating update (``integrate_sets``) leaves its inputs as they were;
and the wrapper refuses what the kernels do not take. The ``cuda`` tests
hold the kernel pair on the card to the plain version and to the chain at
the tutorial launch's shapes (8 robots, 2048^2 and 1024^2), with 1 and 8
robots gated, and at odd shapes. This file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_map_tail.py
"""

import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import cell_models as cm
from hector_slam_tpu_torch.core.mapping import integrate_sets
from hector_slam_tpu_torch.core.slam import quads_of
from hector_slam_tpu_torch.ops import map_tail as mt

MODELS = (cm.LOG_ODDS, cm.SIMPLE_COUNT, cm.REFLECTANCE)
# the default update's log-odds free / occupied
LF = ht.UpdateConfig().log_odds_free
LO = ht.UpdateConfig().log_odds_occupied
# (robots, level shapes): a fleet's pyramid of odd sizes
SMALL = (3, ((37, 45), (19, 23)))


def _storage(gen, shape, model, dev):
    """Random storage of a cell model, with -0.0 cells and cells at the
    update's limits."""
    u = torch.rand(shape, generator=gen, device=dev)
    if model == cm.LOG_ODDS:
        s = (u - 0.5) * 12.0
        s = torch.where(u > 0.97, torch.full_like(s, 50.0), s)
        s = torch.where((u > 0.94) & (u <= 0.97),
                        torch.full_like(s, 49.9), s)
    elif model == cm.SIMPLE_COUNT:
        s = u
        s = torch.where(u > 0.97, torch.full_like(s,
                                                  float(cm._SC_OCC_LIMIT)), s)
        s = torch.where(u < 0.03, torch.full_like(s,
                                                  float(cm._SC_FREE_LIMIT)), s)
    else:
        s = torch.floor(u * 6.0)
        s = torch.where(u < 0.3, torch.zeros_like(s), s)
    return torch.where((u > 0.45) & (u < 0.5), torch.full_like(s, -0.0), s)


def tail_inputs(robots, shapes, model, gated, dev, seed=5):
    """A per-robot pyramid (``robots`` None: one map), its quads, painted
    cell sets (~1/3 of the cells free, ~1/10 occupied) and gates:
    ``gated`` True / False for one gate, or a list of the gated robots
    for one gate a robot."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lead = () if robots is None else (robots,)
    chan = (2,) if model == cm.REFLECTANCE else ()
    levels = tuple(_storage(gen, lead + chan + hw, model, dev)
                   for hw in shapes)
    sets = [(torch.rand(lead + hw, generator=gen, device=dev) < 0.33,
             torch.rand(lead + hw, generator=gen, device=dev) < 0.1)
            for hw in shapes]
    if isinstance(gated, bool):
        gate = torch.tensor(gated, device=dev)
    else:
        gate = torch.zeros(robots, dtype=torch.bool, device=dev)
        gate[list(gated)] = True
    return levels, quads_of(levels, model), sets, gate


def chain(levels, sets, gate, model):
    """What the step bodies computed before the kernel pair: the
    update, the gate's select and the quads of the chosen levels."""
    new = []
    for lv, (free_set, occ_set) in zip(levels, sets):
        u = cm.apply_update(lv, free_set & ~occ_set, occ_set, model, LF, LO)
        new.append(torch.where(gate.reshape((-1,) + (1,) * (lv.dim() - 1)),
                               u, lv))
    return tuple(new), quads_of(new, model)


def bits(t):
    return t.contiguous().view(torch.int32)


def same_bits(a, b):
    return torch.equal(bits(a), bits(b))


GATES = {"one_gate_set": True, "one_gate_unset": False,
         "mixed_robots": (0, 2)}


def _gated_rows(gate_kind, robots):
    g = GATES[gate_kind]
    if isinstance(g, bool):
        return list(range(robots)) if g else []
    return list(g)


@pytest.mark.parametrize("gate_kind", list(GATES))
@pytest.mark.parametrize("model", MODELS)
def test_plain_tail_bit_equal_to_the_chain(model, gate_kind):
    robots, shapes = SMALL
    levels, quads, sets, gate = tail_inputs(robots, shapes, model,
                                            GATES[gate_kind], "cpu")
    want_levels, want_quads = chain(levels, sets, gate, model)
    mt.map_tail(levels, quads, sets, gate, model, LF, LO)
    for got, want in zip(levels + quads, want_levels + want_quads):
        assert same_bits(got, want)


@pytest.mark.parametrize("gate_kind", list(GATES))
@pytest.mark.parametrize("model", MODELS)
def test_ungated_maps_keep_their_bits_and_memory(model, gate_kind):
    """Quads that no packing gives (random bits) stay where a gate did
    not fire; gated maps get new quads, and their -0.0 cells +0.0."""
    robots, shapes = SMALL
    levels, _, sets, gate = tail_inputs(robots, shapes, model,
                                        GATES[gate_kind], "cpu")
    gen = torch.Generator().manual_seed(9)
    quads = tuple(torch.rand(q.shape, generator=gen) - 7.0
                  for q in quads_of(levels, model))
    before = [t.clone() for t in levels + quads]
    ptrs = [t.data_ptr() for t in levels + quads]
    mt.map_tail(levels, quads, sets, gate, model, LF, LO)
    assert [t.data_ptr() for t in levels + quads] == ptrs
    gated = _gated_rows(gate_kind, robots)
    want_quads = quads_of(levels, model)
    for r in range(robots):
        for lv, old in zip(levels, before[:len(levels)]):
            if r in gated:
                neg_zero = bits(old[r]) == bits(torch.tensor(-0.0))
                assert neg_zero.any()
                assert not (bits(lv[r]) == bits(torch.tensor(-0.0))).any()
            else:
                assert same_bits(lv[r], old[r])
        for q, old, want in zip(quads, before[len(levels):], want_quads):
            assert same_bits(q[r], want[r] if r in gated else old[r])


@pytest.mark.parametrize("model", MODELS)
def test_non_donating_update_leaves_its_inputs(model):
    """``integrate_sets`` writes copies unless it is told the maps are
    its own: then the results are the inputs themselves, equal to the
    copies."""
    robots, shapes = SMALL
    levels, quads, sets, gate = tail_inputs(robots, shapes, model, (1,),
                                            "cpu")
    cfg = ht.SlamConfig(update=ht.UpdateConfig(cell_model=model))
    before = [t.clone() for t in levels + quads]
    new_levels, new_quads = integrate_sets(levels, quads, sets, gate, cfg)
    assert all(same_bits(a, b) for a, b in zip(levels + quads, before))
    assert not same_bits(new_levels[0], levels[0])
    want = chain(levels, sets, gate, model)
    assert all(same_bits(a, b) for a, b in zip(new_levels + new_quads,
                                               want[0] + want[1]))
    own_levels, own_quads = integrate_sets(levels, quads, sets, gate, cfg,
                                           in_place=True)
    assert all(a is b for a, b in zip(own_levels + own_quads,
                                      levels + quads))
    assert all(same_bits(a, b) for a, b in zip(levels + quads,
                                               new_levels + new_quads))
    # a pyramid given without quads has them packed first
    fresh_levels, fresh_quads = integrate_sets(
        tuple(before[:len(levels)]), (), sets, gate, cfg)
    assert all(same_bits(a, b) for a, b in zip(fresh_levels + fresh_quads,
                                               new_levels + new_quads))


def _bad(case):
    """map_tail's arguments for one refused input."""
    levels, quads, sets, gate = tail_inputs(3, ((8, 12), (4, 6)),
                                            cm.LOG_ODDS, (0,), "cpu")
    levels, quads, sets = list(levels), list(quads), list(sets)
    model = cm.LOG_ODDS
    if case == "storage_dtype":
        levels[1] = levels[1].double()
    elif case == "quads_dtype":
        quads[0] = quads[0].half()
    elif case == "set_dtype":
        sets[0] = (sets[0][0].to(torch.uint8), sets[0][1])
    elif case == "gate_dtype":
        gate = gate.to(torch.int32)
    elif case == "quads_shape":
        quads[1] = quads[1][:, :-1]
    elif case == "set_shape":
        sets[1] = (sets[1][0], sets[1][1][:2])
    elif case == "gate_shape":
        gate = torch.ones(2, dtype=torch.bool)
    elif case == "maps_differ":
        levels[1], quads[1], sets[1] = levels[1][:2], quads[1][:2], (
            sets[1][0][:2], sets[1][1][:2])
    elif case == "device":
        sets[1] = (sets[1][0].to("meta"), sets[1][1])
    elif case == "gate_device":
        gate = gate.to("meta")
    elif case == "storage_strides":
        levels[0] = levels[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "set_strides":
        sets[0] = (sets[0][0], sets[0][1].transpose(1, 2).contiguous()
                   .transpose(1, 2))
    elif case == "model":
        model = cm.PROB
    elif case == "level_count":
        quads = quads[:1]
    elif case == "too_many_levels":
        reps = mt.MAX_LEVELS // 2 + 1
        levels, quads, sets = levels * reps, quads * reps, sets * reps
    return levels, quads, sets, gate, model


REFUSED = {"storage_dtype": TypeError, "quads_dtype": TypeError,
           "set_dtype": TypeError, "gate_dtype": TypeError,
           "quads_shape": ValueError, "set_shape": ValueError,
           "gate_shape": ValueError, "maps_differ": ValueError,
           "device": ValueError, "gate_device": ValueError,
           "storage_strides": ValueError, "set_strides": ValueError,
           "model": ValueError, "level_count": ValueError,
           "too_many_levels": ValueError}


@pytest.mark.parametrize("case", list(REFUSED))
def test_map_tail_refuses_bad_inputs(case):
    levels, quads, sets, gate, model = _bad(case)
    before = [t.clone() for t in levels + quads if t.device.type == "cpu"]
    with pytest.raises(REFUSED[case], match="map_tail"):
        mt.map_tail(levels, quads, sets, gate, model, LF, LO)
    after = [t for t in levels + quads if t.device.type == "cpu"]
    assert all(same_bits(a, b) for a, b in zip(after, before))


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(dev, robots, shapes, model, gated):
    levels, quads, sets, gate = tail_inputs(robots, shapes, model, gated,
                                            dev)
    want_levels, want_quads = chain(levels, sets, gate, model)
    plain = ([t.clone() for t in levels], [t.clone() for t in quads])
    mt.map_tail_plain(*plain, sets, gate, model, LF, LO)
    launches = mt.map_tail.launches
    ptrs = [t.data_ptr() for t in levels + quads]
    mt.map_tail(levels, quads, sets, gate, model, LF, LO)
    torch.cuda.synchronize()
    assert mt.map_tail.launches - launches == 2
    assert [t.data_ptr() for t in levels + quads] == ptrs
    for got, p, want in zip(levels + quads, plain[0] + plain[1],
                            want_levels + want_quads):
        assert same_bits(got, p) and same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [(3,), tuple(range(8))],
                         ids=["1_of_8", "8_of_8"])
@pytest.mark.parametrize("model", MODELS)
def test_kernels_bit_equal_to_plain_at_tutorial_shapes_on_card(
        cuda_device, model, gated):
    _kernel_vs_plain(cuda_device, 8, ((2048, 2048), (1024, 1024)), model,
                     gated)


@pytest.mark.cuda
@pytest.mark.parametrize("robots,shapes,gated", [
    (3, SMALL[1], (0, 2)), (None, ((300, 257), (150, 129)), True),
    (None, ((300, 257),), False), (2, ((16, 1), (1, 40)), True),
    (70, ((33, 65),), tuple(range(0, 70, 3)))])
@pytest.mark.parametrize("model", MODELS)
def test_kernels_bit_equal_to_plain_at_odd_shapes_on_card(
        cuda_device, model, robots, shapes, gated):
    _kernel_vs_plain(cuda_device, robots, shapes, model, gated)


@pytest.mark.cuda
def test_kernels_refuse_misaligned_quads_on_card(cuda_device):
    levels, quads, sets, gate = tail_inputs(None, ((8, 8),), cm.LOG_ODDS,
                                            True, cuda_device)
    buf = torch.zeros(quads[0].numel() + 1, device=cuda_device)
    shifted = buf[1:].view(quads[0].shape)
    with pytest.raises(ValueError, match="16-byte"):
        mt.map_tail(levels, (shifted,), sets, gate, cm.LOG_ODDS, LF, LO)
