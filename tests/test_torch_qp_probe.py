"""K1's probe form (csrc/qp_fused3d.cuh, P = true) from the host's side:
the reduction of its buffer (kernels/bwdtrans3d.qp_probe_reduce), its
layout against the kernel's, the buffer's growth, qp_phases, and the
benchmark's readers qp_wait_pct, qp_stage1_pct, qp_stage2_pct and
qp_slot_idle_pct (port_bench/metrics) on a stub of qp_phases; on the card
(`cuda`), a probed launch against an unprobed one at depth 1 and 2."""

import os
import re
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import qp_probe, spec  # noqa: E402
from port_bench.run import Run  # noqa: E402
from tpu_bench_torch.kernels import bwdtrans3d as k1  # noqa: E402

CUH = os.path.join(os.path.dirname(k1.__file__), "..", "csrc",
                   "qp_fused3d.cuh")
READERS = ("qp_wait_pct", "qp_stage1_pct", "qp_stage2_pct",
           "qp_slot_idle_pct")
QP_CELLS = ["hex8-f32-qp", "hex8-f64-qp", "hex10-f64-qp", "quad8-f32-qp",
            "quad32-f64-qp", "hex8-bf16-qp", "quad8-bf16-qp"]
ROW = len(k1.QP_PHASES)
RING = k1.QP_PROBE_HEAD + k1.QP_PROBE_ROWS * ROW
RECORDS = RING + 2 * k1.QP_PROBE_LAUNCHES


def _buffer(capacity=4):
    return [0] * k1._qp_probe_words(capacity)


def _span(words, n, start, end):
    """Launch n's span as the card leaves it: the complement of the start
    (an int64 word), then the exit."""
    at = RING + 2 * (n % k1.QP_PROBE_LAUNCHES)
    words[at] = ~start
    words[at + 1] = end


def _read(name, phases, monkeypatch):
    monkeypatch.setattr(k1, "qp_phases", lambda device=None: phases)
    run = Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
              enqueue_ns=[], setup_s=1.0, library_s=None)
    return spec.load("metrics", name).read(run)


def _phases(block=1000, wait=100, stage1=200, stage2=600, blocks=None,
            slots=4):
    blocks = [(0, 10, 0, 20), (0, 10, 1, 20)] if blocks is None else blocks
    return {"launches": 3, "cycles": {"block": block, "wait": wait,
                                      "stage1": stage1, "stage2": stage2},
            "spans": [(0, 10)] * 3, "grid": len(blocks), "slots": slots,
            "blocks": blocks}


@pytest.fixture
def no_probes(monkeypatch):
    """kernels/bwdtrans3d.qp_probes empty during the test."""
    monkeypatch.setattr(k1, "qp_probes", {})
    return k1.qp_probes


# ---- the reduction of the buffer ------------------------------------------


def test_reduce_sums_the_rows_of_each_phase():
    words = _buffer()
    for r in (0, 5, k1.QP_PROBE_ROWS - 1):
        for k in range(ROW):
            words[k1.QP_PROBE_HEAD + r * ROW + k] = (k + 1) * 10 + r
    got = k1.qp_probe_reduce(words, 1)["cycles"]
    rows = 5 + k1.QP_PROBE_ROWS - 1
    assert got == {phase: 3 * (k + 1) * 10 + rows
                   for k, phase in enumerate(k1.QP_PHASES)}


def test_reduce_reads_words_above_2_63_unsigned():
    """A total past 2^63 comes back from the card as a negative int64."""
    words = _buffer()
    words[k1.QP_PROBE_HEAD] = -1  # 2^64 - 1 cycles of `block`, row 0
    assert k1.qp_probe_reduce(words, 1)["cycles"]["block"] == 2**64 - 1


def test_reduce_gives_the_newest_launch_spans_oldest_first():
    """Spans start from their complemented word; past the ring's length
    only the newest QP_PROBE_LAUNCHES launches are left, oldest first."""
    words = _buffer()
    n = k1.QP_PROBE_LAUNCHES + 3
    for i in range(n - k1.QP_PROBE_LAUNCHES, n):
        _span(words, i, 1000 * i, 1000 * i + 7)
    spans_ns = k1.qp_probe_reduce(words, n)["spans"]
    assert len(spans_ns) == k1.QP_PROBE_LAUNCHES
    assert spans_ns[0] == (1000 * 3, 1000 * 3 + 7)
    assert spans_ns[-1] == (1000 * (n - 1), 1000 * (n - 1) + 7)
    assert k1.qp_probe_reduce(words, 2)["spans"] == [
        (1000 * k1.QP_PROBE_LAUNCHES, 1000 * k1.QP_PROBE_LAUNCHES + 7),
        (1000 * (k1.QP_PROBE_LAUNCHES + 1),
         1000 * (k1.QP_PROBE_LAUNCHES + 1) + 7)]


def test_reduce_gives_the_newest_launch_block_records():
    """The head's grid and slots; (start, exit, SM, cycles) of each block,
    as many as the grid, from words (start, exit, cycles, SM)."""
    words = _buffer(capacity=4)
    words[0], words[1], words[2] = 3, 264, 9
    for b in range(4):
        at = RECORDS + b * k1.QP_PROBE_RECORD
        words[at:at + 4] = [100 + b, 200 + b, 50 + b, b % 2]
    got = k1.qp_probe_reduce(words, 10)
    assert (got["grid"], got["slots"], got["launches"]) == (3, 264, 10)
    assert got["blocks"] == [(100 + b, 200 + b, b % 2, 50 + b)
                             for b in range(3)]


def test_reduce_gives_no_more_blocks_than_it_holds():
    words = _buffer(capacity=2)
    words[0] = 5
    assert len(k1.qp_probe_reduce(words, 1)["blocks"]) == 2


def test_layout_mirrors_the_kernels():
    """QP_PROBE_HEAD, _ROWS, _LAUNCHES, _RECORD and the phases in the order
    of csrc/qp_fused3d.cuh's QPPhase."""
    text = open(CUH).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("QP_PROBE_HEAD") == k1.QP_PROBE_HEAD
    assert const("QP_PROBE_ROWS") == k1.QP_PROBE_ROWS
    assert const("QP_PROBE_LAUNCHES") == k1.QP_PROBE_LAUNCHES
    assert const("QP_PROBE_RECORD") == k1.QP_PROBE_RECORD
    assert const("QP_PHASES") == len(k1.QP_PHASES)
    enum = re.search(r"enum QPPhase : int \{([^}]*)\}", text)[1]
    order = re.findall(r"QP_(\w+) = (\d+)", enum)
    assert [(name.lower(), int(v)) for name, v in order] == [
        (phase, k) for k, phase in enumerate(k1.QP_PHASES)]


# ---- the buffer and qp_phases ------------------------------------------


def test_buffer_is_made_zeroed_and_grows_keeping_its_sums(no_probes):
    """The first probed launch of a device makes its buffer, zeroed, with
    at least QP_PROBE_MIN_RECORDS records; a launch of more blocks grows
    it, its head, totals, spans and launch count kept."""
    x = torch.zeros(2, 3)  # device index -1
    probe = k1._qp_probe(x, 5)
    assert probe.capacity == k1.QP_PROBE_MIN_RECORDS
    assert probe.words.dtype == torch.int64 and not probe.words.any()
    assert probe.words.numel() == k1._qp_probe_words(probe.capacity)
    assert k1._qp_probe(x, probe.capacity) is probe
    probe.words[:RECORDS] = 7
    probe.words[RECORDS:] = 9
    probe.launches = 4
    grown = k1._qp_probe(x, probe.capacity + 1)
    assert grown.capacity == 2 * probe.capacity and no_probes[-1] is grown
    assert grown.launches == 4
    assert bool((grown.words[:RECORDS] == 7).all())
    assert not grown.words[RECORDS:].any()


def test_phases_none_without_a_probed_launch(no_probes):
    assert k1.qp_phases(-1) is None
    no_probes[-1] = k1.QPProbe(torch.zeros(k1._qp_probe_words(1),
                                           dtype=torch.int64), 1, 0)
    assert k1.qp_phases(-1) is None


def test_phases_reads_the_buffer_of_its_device(no_probes):
    words = torch.zeros(k1._qp_probe_words(2), dtype=torch.int64)
    words[0], words[1] = 1, 8
    words[k1.QP_PROBE_HEAD + 2] = 30  # stage1 of row 0
    words[RECORDS:RECORDS + 4] = torch.tensor([5, 9, 40, 3])
    no_probes[-1] = k1.QPProbe(words, 2, 1)
    got = k1.qp_phases(-1)
    assert got["cycles"]["stage1"] == 30 and got["launches"] == 1
    assert got["blocks"] == [(5, 9, 3, 40)] and got["slots"] == 8


# ---- chip_smoke.py's reading of ptxas -------------------------------------

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")
# ptxas's lines for K1 at quad8-f32-qp's (128, 4, 1, 256, SIMT): the parent
# tree's instance, and this tree's plain and probe instances
PARENT = "_ZN46_GLOBAL__N__1f2e3d4c_13_bwdtrans3d_cu_9a8b7c6d17qp_fused3d_kernelIfLi128ELi4ELi1ELi256ELNS_6QPBodyE0EEEvPKT_S4_S4_PS2_iiiixPy"  # noqa: E501
PLAIN = "_ZN46_GLOBAL__N__30d0f19a_13_bwdtrans3d_cu_521c71a117qp_fused3d_kernelIfLi128ELi4ELi1ELi256ELNS_6QPBodyE0ELb0EJEEEvPKT_S4_S4_PS2_iiiixPyDpT6_"  # noqa: E501
PROBE = "_ZN52_GLOBAL__N__df8a79b0_19_qp_fused3d_probe_cu_8ca208b717qp_fused3d_kernelIfLi128ELi4ELi1ELi256ELNS_6QPBodyE0ELb1EJNS_7QPProbeEEEEvPKT_S5_S5_PS3_iiiixPyDpT6_"  # noqa: E501


def _ptxas(name, regs):
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            f"loads\nptxas info    : Used {regs} registers, used 1 "
            "barriers\n")


@pytest.fixture(scope="module")
def smoke():
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("chip_smoke_", SMOKE)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def test_smoke_keys_k1_instances_with_or_without_the_probe(smoke):
    """An instance's key is its template arguments up to the stage-2 body,
    whether or not the name carries the probe's argument."""
    found = smoke.k1_ptxas(_ptxas(PLAIN, 77) + _ptxas(PROBE, 80))
    key = "fLi128ELi4ELi1ELi256ELNS_6QPBodyE0E"
    assert sorted(found) == [(key, False), (key, True)]
    assert found[(key, True)][-1].endswith("Used 80 registers, used 1 "
                                           "barriers")
    assert smoke.k1_ptxas(_ptxas(PARENT, 77)) == {
        (key, False): found[(key, False)]}


@pytest.mark.parametrize("regs,same", [(77, True), (78, False)])
def test_smoke_holds_plain_registers_to_the_parents(smoke, regs, same):
    log = _ptxas(PLAIN, regs) + _ptxas(PROBE, 80)
    if same:
        smoke.same_k1_registers(log, _ptxas(PARENT, 77))
    else:
        with pytest.raises(AssertionError):
            smoke.same_k1_registers(log, _ptxas(PARENT, 77))


def test_smoke_compares_the_parents_plain_lines_not_its_probes(smoke):
    """A parent with K1's probe form holds both forms' lines under one
    instance: this tree's plain lines are held to the parent's plain ones,
    not to its probe's."""
    parent = _ptxas(PLAIN, 77) + _ptxas(PROBE, 80)
    smoke.same_k1_registers(_ptxas(PLAIN, 77) + _ptxas(PROBE, 80), parent)
    with pytest.raises(AssertionError):
        smoke.same_k1_registers(_ptxas(PLAIN, 80), parent)


def test_smoke_lists_instances_the_parent_lacks(smoke, capsys):
    """An instance of this tree's that the parent lacks (a new stage-2
    body) is listed, not compared; one of the parent's that this tree
    lacks fails."""
    hmma = PLAIN.replace("IfLi128ELi4ELi1ELi256ELNS_6QPBodyE0E",
                         "I13__nv_bfloat16Li64ELi4ELi1ELi256ELNS_6QPBodyE3E")
    smoke.same_k1_registers(_ptxas(PLAIN, 77) + _ptxas(hmma, 72),
                            _ptxas(PARENT, 77))
    out = capsys.readouterr().out
    assert "K1's 1 plain instances as the parent's" in out
    assert "parent lacks: 13__nv_bfloat16Li64ELi4ELi1ELi256ELNS_6QPBodyE3E" \
        in out
    with pytest.raises(AssertionError):
        smoke.same_k1_registers(_ptxas(hmma, 72), _ptxas(PARENT, 77))


@pytest.mark.parametrize("regs,blocks", [(77, 3), (80, 3), (81, 2),
                                         (128, 2), (129, 1)])
def test_smoke_counts_blocks_an_sm_by_registers(smoke, regs, blocks):
    """Registers go to a thread in granules of 8: 256 threads of 80 fit
    an SM's 65,536 three times, of 81 (88) twice."""
    lines = _ptxas(PLAIN, regs).splitlines()
    assert smoke.k1_resident(lines, 256, 1000) == blocks


def test_smoke_counts_blocks_an_sm_by_shared_memory(smoke):
    lines = _ptxas(PLAIN, 32).splitlines()
    assert smoke.k1_resident(lines, 256, 120000) == 1
    assert smoke.k1_resident(lines, 256, 76000) == 3


# ---- the readers ----------------------------------------------------------


@pytest.mark.parametrize("name,phase,want", [
    ("qp_wait_pct", "wait", 10.0), ("qp_stage1_pct", "stage1", 20.0),
    ("qp_stage2_pct", "stage2", 60.0)])
def test_shares_of_synthetic_totals(name, phase, want, monkeypatch):
    assert _read(name, _phases(), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_a_probed_launch(name, monkeypatch):
    assert _read(name, None, monkeypatch) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_none_for_a_program_without_the_probe(name, monkeypatch):
    """A program whose K1 module has no qp_phases (an earlier tree)."""
    monkeypatch.delattr(k1, "qp_phases")
    run = Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
              enqueue_ns=[], setup_s=1.0, library_s=None)
    assert spec.load("metrics", name).read(run) is None


@pytest.mark.parametrize("name", READERS[:3])
def test_shares_none_for_no_block_cycles(name, monkeypatch):
    assert _read(name, _phases(block=0, wait=0, stage1=0, stage2=0),
                 monkeypatch) is None


def test_slot_idle_of_a_launch_with_a_tail(monkeypatch):
    """Two slots over 100 ns: one busy throughout, one for its first 40
    ns and then 20 ns more (two blocks): 160 of 200 slot-ns held."""
    blocks = [(1000, 1100, 0, 200), (1000, 1040, 1, 80),
              (1040, 1060, 1, 40)]
    got = _read("qp_slot_idle_pct", _phases(blocks=blocks, slots=2),
                monkeypatch)
    assert got == pytest.approx(20.0)


def test_slot_idle_of_a_full_grid_reads_0(monkeypatch):
    blocks = [(500, 900, sm, 800) for sm in range(4)]
    assert _read("qp_slot_idle_pct", _phases(blocks=blocks, slots=4),
                 monkeypatch) == 0.0


def test_slot_idle_counts_an_untimed_block_by_its_cycles(monkeypatch):
    """A block between the first and last waves has no %globaltimer
    stamps (0, 0), one of the first wave only its start: their cycles
    count at the blocks of both stamps' 2 cycles a ns.  Two slots over 100
    ns from the first wave's start: 40 + 60 on one, 20 + 20 + 30 on the
    other, 170 held."""
    blocks = [(1000, 0, 0, 80), (1040, 1100, 0, 120), (1000, 0, 1, 40),
              (0, 0, 1, 40), (1070, 1100, 1, 60)]
    got = _read("qp_slot_idle_pct", _phases(blocks=blocks, slots=2),
                monkeypatch)
    assert got == pytest.approx(15.0)


def test_slot_idle_none_where_records_miss_blocks(monkeypatch):
    phases = _phases()
    phases["grid"] += 1
    assert _read("qp_slot_idle_pct", phases, monkeypatch) is None


@pytest.mark.parametrize("blocks,slots", [([], 4), ([(5, 9, 0, 1)], 0),
                                          ([(5, 5, 0, 1)], 1),
                                          ([(0, 0, 0, 9)], 1),
                                          ([(5, 0, 0, 9)], 1),
                                          ([(5, 9, 0, 0)], 1)])
def test_slot_idle_none_without_blocks_slots_or_length(blocks, slots):
    assert qp_probe.slot_idle_pct(blocks, slots) is None


# ---- kernel_blocks --only k1 --probe --------------------------------------


def _totals(words, block, wait, stage1, stage2):
    """The phases' totals of a probe buffer, split over two rows."""
    for k, v in enumerate((block, wait, stage1, stage2)):
        words[k1.QP_PROBE_HEAD + k] = v - v // 3
        words[k1.QP_PROBE_HEAD + 7 * ROW + k] = v // 3


def test_sweep_shares_are_the_cells_readings_of_one_shapes_launches(
        monkeypatch):
    """From a fake buffer read before and after a shape's probed calls:
    the shares of the cycles between the two readings, under the qp cells'
    metric names, the rest of the block outside the three phases, and the
    newest launch's slot idle share as the cells' reader takes it."""
    from tpu_bench_torch.benchmarks import kernel_blocks

    words = _buffer(capacity=3)
    _totals(words, 1000, 100, 200, 600)
    before = k1.qp_probe_reduce(words, 2)
    _totals(words, 1000 + 4000, 100 + 400, 200 + 1000, 600 + 2000)
    words[0], words[1] = 3, 2  # the newest launch: 3 blocks, 2 slots
    blocks = [(1000, 1100, 0, 200), (1000, 1040, 1, 80), (1040, 1060, 1, 40)]
    for b, (start, end, sm, cycles) in enumerate(blocks):
        at = RECORDS + b * k1.QP_PROBE_RECORD
        words[at:at + 4] = [start, end, cycles, sm]
    after = k1.qp_probe_reduce(words, 5)
    got = kernel_blocks.probe_shares(before, after)
    assert got == pytest.approx({"qp_wait_pct": 10.0, "qp_stage1_pct": 25.0,
                                 "qp_stage2_pct": 50.0, "rest": 15.0,
                                 "qp_slot_idle_pct": 20.0})
    assert list(got) == [*READERS[:3], "rest", READERS[3]]
    assert kernel_blocks.probe_shares(None, before) == pytest.approx(
        {"qp_wait_pct": 10.0, "qp_stage1_pct": 20.0, "qp_stage2_pct": 60.0,
         "rest": 10.0, "qp_slot_idle_pct": None})
    monkeypatch.setattr(k1, "qp_phases", lambda device=None: after)
    assert got["qp_slot_idle_pct"] == _read("qp_slot_idle_pct", after,
                                            monkeypatch)


def test_probed_refuses_a_cpu_tensor():
    x, b0, c12t = torch.zeros(8, 4), torch.zeros(2, 3), torch.zeros(9, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        k1.qp_probed(x, b0, c12t, nrq=4)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_the_qp_cells(name):
    """Each reader is a per-layer metric of the seven qp cells, of K1's
    layer, moving gdof_s."""
    [entry] = [m for m in spec.benchmark()["per_layer"] if m["name"] == name]
    assert entry["workloads"] == QP_CELLS
    assert (entry["source"], entry["layer"], entry["moves"], entry["unit"]) \
        == ("program_counter", "hand kernels", "gdof_s", "%")
    assert entry["better"] == ("higher" if name == "qp_stage2_pct"
                               else "lower")


# ---- on the card ----------------------------------------------------------

# (label, nm0, nrq, nq0, nkj, E): b05 at nq=8^3 and b04 at nq=8^2, E past
# a whole number of tiles
CARD_SHAPES = [("b05 8^3", 7, 49, 8, 64, 4099), ("b04 8^2", 7, 7, 8, 8, 4099)]


# (dtype, stage-2 body, where C12T lives)
CARD_FORMS = [(torch.float32, "simt", "smem"), (torch.float64, "simt", "smem"),
              (torch.float64, "dmma", "regs"), (torch.bfloat16, "hmma", "regs"),
              (torch.float32, "tf32", "regs")]


@pytest.mark.cuda
@pytest.mark.parametrize("form", CARD_FORMS,
                         ids=["f32", "f64-simt", "f64-dmma-regs",
                              "bf16-hmma-regs", "f32-tf32-regs"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: s[0])
def test_probed_launch_writes_the_plain_forms_bits(shape, depth, form,
                                                   no_probes):
    """A profiled call (the probe form) writes the same bits as an
    unprofiled one at (16, 8, depth, 256, body); its shares lie in [0,
    100], wait + stage 1 + stage 2 within 100, every block of the launch
    has a record, and the launch's span holds every block's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype, body, where = form
    _probed_writes_the_plain_forms_bits(shape, dtype, dict(
        epb=16, planes=8, depth=depth, threads=256, body=body, where=where))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES + [("b04 32^2", 31, 31, 32,
                                                  32, 1005)],
                         ids=lambda s: s[0])
def test_probed_launch_writes_the_plain_forms_bits_with_stage_1_on_dmma(
        shape, no_probes):
    """As test_probed_launch_writes_the_plain_forms_bits, in f64 with
    stage 1 on DMMA beside the held DMMA stage 2, at its one setting (16,
    16, 1, 256: persistent blocks, one slot), also at b04 32^2 (its
    rule's) on a ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _probed_writes_the_plain_forms_bits(shape, torch.float64, dict(
        epb=16, planes=16, depth=1, threads=256, body="dmma", where="regs",
        stage1="dmma"))


def _probed_writes_the_plain_forms_bits(shape, dtype, knobs):
    _, nm0, nrq, nq0, nkj, e = shape
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, b0, c = (torch.randn(*s, generator=gen, device="cuda", dtype=dtype)
                for s in ((nm0 * nrq, e), (nm0, nq0), (nkj, nrq)))
    knobs = dict(knobs, nrq=nrq)
    plain = k1.qp_shared3d_flat(x, b0, c, **knobs)
    with profile(activities=[ProfilerActivity.CPU]):
        probed = k1.qp_shared3d_flat(x, b0, c, **knobs)
    torch.cuda.synchronize()
    assert torch.equal(plain, probed)
    got = k1.qp_phases()
    assert got["launches"] == 1 and len(got["blocks"]) == got["grid"] > 0
    cycles = got["cycles"]
    shares = [100.0 * cycles[p] / cycles["block"]
              for p in ("wait", "stage1", "stage2")]
    assert all(0.0 <= s <= 100.0 for s in shares) and sum(shares) <= 100.0
    assert cycles["stage2"] > 0 and cycles["stage1"] > 0
    idle = qp_probe.slot_idle_pct(got["blocks"], got["slots"])
    assert 0.0 <= idle <= 100.0
    blocks = got["blocks"]
    assert all(b[3] > 0 for b in blocks)
    assert any(b[0] and b[1] > b[0] for b in blocks)
    [(start, end)] = got["spans"]
    assert (start, end) == (min(b[0] for b in blocks if b[0]),
                            max(b[1] for b in blocks))
    assert torch.equal(k1.qp_probed(x, b0, c, nrq=nrq),
                       k1.qp_shared3d_flat(x, b0, c, nrq=nrq))
    assert k1.qp_phases()["launches"] == 2
