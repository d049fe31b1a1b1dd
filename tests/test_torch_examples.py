"""The port's twins of the reference's examples against the examples
themselves, on the CPU: ``repro_torch.examples.finetune_lm`` and
``repro_torch.examples.serve_adapted``.

The reference examples are loaded from ``examples/`` with ``importlib``.
Each twin's config, flags and constants are the example's. ``finetune_lm
--small --epochs 3`` runs the reference's own ``main`` (its factories
wrapped to record each epoch's step losses, its ``init_lm`` and
``init_adapters`` draws kept), and the twin's ``finetune`` from those draws,
carried across by ``repro_torch.convert``, on the same staged data: every
step loss within rtol 1e-5 (float32; the two sum the products and the
readout's log-softmax in different orders). ``serve_adapted`` serves the
reference's weights, adapter draws and prompts: the mixed batch's
temperature-0 tokens equal the reference's ``generate_grouped``'s, and all
four rows equal single-tenant serving.

One intra-op thread: small products run fastest so and spare the cores
other test processes share.
"""

import ast
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.adapter_pool import AdapterPool as JPool  # noqa: E402
from repro.core.runtime import generate_grouped as j_generate_grouped  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.examples import finetune_lm as FL  # noqa: E402
from repro_torch.examples import serve_adapted as SA  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_example(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_source(name: str) -> ast.FunctionDef:
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


@pytest.mark.parametrize("small", [True, False])
def test_finetune_lm_config_is_the_examples(small):
    ref = _reference_example("finetune_lm")
    assert dataclasses.asdict(FL.build_100m_config(small)) == dataclasses.asdict(ref.build_100m_config(small))


def test_finetune_lm_flags_are_the_examples_and_device():
    """Every ``add_argument`` of the reference's ``main``, with its default,
    type and choices, and ``--device`` defaulting to the card."""
    want = {}
    for node in ast.walk(_main_source("finetune_lm")):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            want[node.args[0].value] = {
                "default": ast.literal_eval(kw["default"]) if "default" in kw else None,
                "type": kw["type"].id if "type" in kw else None,
                "choices": ast.literal_eval(kw["choices"]) if "choices" in kw else None,
            }
    got = {a.option_strings[0]: {"default": a.default, "type": a.type.__name__ if a.type else None,
                                 "choices": a.choices}
           for a in FL.build_parser()._actions if a.option_strings and a.dest != "help"}
    assert got.pop("--device") == {"default": "cuda", "type": None, "choices": None}
    for opt, spec in want.items():
        if spec["default"] is None and opt == "--small":
            spec["default"] = False   # store_true
        assert got[opt] == spec, opt
    assert set(got) == set(want)


def test_serve_adapted_config_and_constants_are_the_examples():
    assert dataclasses.asdict(SA.build_config()) == dataclasses.asdict(reduce_config(get_config("gemma2-9b")))
    consts = {}
    for node in ast.walk(_main_source("serve_adapted")):
        if isinstance(node, ast.Assign) and isinstance(node.value, (ast.Constant, ast.Tuple)):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            names = node.targets[0].elts if isinstance(node.targets[0], ast.Tuple) else [node.targets[0]]
            values = value if isinstance(value, tuple) else (value,)
            consts.update({n.id: v for n, v in zip(names, values)})
    want = {"rank": SA.RANK, "batch": SA.BATCH, "prompt_len": SA.PROMPT_LEN, "gen": SA.GEN}
    assert {k: consts[k] for k in want} == want


def test_finetune_lm_small_follows_the_reference_example(monkeypatch, capsys):
    ref = _reference_example("finetune_lm")
    seen = {"losses": []}

    def record(factory):
        def make(*a, **kw):
            epoch = factory(*a, **kw)

            def run(*args):
                out = epoch(*args)
                seen["losses"].append(np.asarray(out[-1]))
                return out

            return run

        return make

    def keep(name, fn):
        def draw(*a, **kw):
            seen[name] = fn(*a, **kw)
            return seen[name]

        return draw

    monkeypatch.setattr(ref.SL, "make_populate_epoch", record(JSL.make_populate_epoch))
    monkeypatch.setattr(ref.SL, "make_cached_epoch", record(JSL.make_cached_epoch))
    monkeypatch.setattr(ref.SL, "init_adapters", keep("adapters", JSL.init_adapters))
    # the reference's init_lm compiled whole: the same draws, a fraction
    # of the op-by-op compile time
    monkeypatch.setattr(ref, "init_lm", keep("params", jax.jit(JL.init_lm, static_argnums=1)))
    monkeypatch.setattr(sys, "argv", ["finetune_lm.py", "--small", "--epochs", "3"])
    ref.main()
    want_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch")]

    args = FL.parse_args(["--small", "--epochs", "3", "--device", "cpu"])
    cfg = FL.build_100m_config(True)
    sl = TSL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32")
    tokens, labels = FL.staged_data(cfg, args)
    store, _ = j_make_pipeline(JDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                                           num_samples=args.samples))
    staged = store.batch(np.arange(args.samples))
    np.testing.assert_array_equal(tokens, staged["tokens"])
    np.testing.assert_array_equal(labels, staged["labels"])
    params = C.params_from_reference(jax.tree.map(np.asarray, seen["params"]), cfg)
    adapters = C.adapters_from_reference(jax.tree.map(np.asarray, seen["adapters"]))
    out = FL.finetune(cfg, sl, params, adapters, torch.as_tensor(tokens), torch.as_tensor(labels),
                      epochs=args.epochs, batch=args.batch)
    got_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
    assert len(out["losses"]) == len(seen["losses"]) == 3
    for got, want in zip(out["losses"], seen["losses"]):
        assert got.shape == want.shape == (args.samples // args.batch,)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # the same lines, the times apart
    assert [ln.split("loss=")[0] for ln in got_lines] == [ln.split("loss=")[0] for ln in want_lines]
    assert out["losses"][-1].mean() < out["losses"][0].mean()


def test_serve_adapted_gives_the_reference_tokens(capsys):
    cfg = SA.build_config()
    jp = jax.jit(JL.init_lm, static_argnums=1)(jax.random.key(0), cfg)
    sl = JSL.SkipLoRAConfig(rank=SA.RANK)
    jpool = JPool(8, cfg, SA.RANK)
    adapters = {}
    for t in range(3):   # the reference example's draws
        ad = JSL.init_adapters(jax.random.key(10 + t), cfg, sl)
        ad["B"] = jax.random.normal(jax.random.key(20 + t), ad["B"].shape) * 0.02
        jpool.register(f"user-{t}", ad)
        adapters[f"user-{t}"] = C.adapters_from_reference(jax.tree.map(np.asarray, ad))
    prompts = jax.random.randint(jax.random.key(3), (SA.BATCH, SA.PROMPT_LEN), 0, cfg.vocab_size)
    want = j_generate_grouped(jp, cfg, prompts, jpool.pools(), jpool.lookup([None, "user-0", "user-1", "user-2"]),
                              max_new=SA.GEN, use_kernel=False)

    params = C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    out = SA.serve(cfg, params, adapters, torch.as_tensor(np.array(prompts)))
    np.testing.assert_array_equal(out["mixed"].numpy(), np.asarray(jnp.asarray(want)))
    assert out["agree"] == SA.BATCH
    assert "rows matching single-tenant serving: 4/4" in capsys.readouterr().out


def test_epoch_graph_entries_are_keyed_on_the_callers_storage(monkeypatch):
    """The LM epochs' graph entries (here on the CPU, the graph route forced
    and each entry made but not run): two caches of equal shapes, or two
    token tensors, give two entries; the same tensors again reuse theirs.
    A replay reads and writes only the storage its entry was keyed on."""
    from repro_torch.core import fleet_finetune as TFF
    from repro_torch.core.cuda_graph import GraphCache
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.optimizers import adamw

    class Entry:
        def run(self, live, carry, consts, idx_mat):
            return list(carry), torch.zeros(idx_mat.shape[0]), {}

        def free(self):
            pass

    graphs = GraphCache(capacity=16)

    def run_epoch_graph(_, key, step, live, carry, consts, idx_mat, **kw):
        return graphs.entry(key + (tuple(idx_mat.shape),), Entry).run(live, carry, consts, idx_mat)

    monkeypatch.setattr(TSL, "graphed", lambda *a: True)
    monkeypatch.setattr(TSL, "run_epoch_graph", run_epoch_graph)
    cfg = FL.build_100m_config(True)
    sl = TSL.SkipLoRAConfig(rank=4, cache_dtype="float32")
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    adapters = TSL.init_adapters(torch.Generator().manual_seed(1), cfg, sl)
    opt = adamw(1e-3)
    tokens = [torch.randint(0, cfg.vocab_size, (8, 16), generator=torch.Generator().manual_seed(s)) for s in (2, 3)]
    caches = [TSL.init_lm_cache(8, cfg, sl, 16) for _ in range(2)]
    idx = torch.arange(8).reshape(2, 4)
    populate = TSL.make_populate_epoch(cfg, sl, opt)
    cached = TSL.make_cached_epoch(cfg, sl, opt)
    for tok, cache in [(tokens[0], caches[0]), (tokens[1], caches[0]), (tokens[0], caches[1]),
                       (tokens[0], caches[0])]:
        populate(params, adapters, {}, opt.init(adapters), cache, tok, tok, idx)
    assert len(graphs) == 3 and graphs.stats["hits"] == 1
    for cache in caches + caches:
        cached(params, adapters, {}, opt.init(adapters), cache, idx)
    assert len(graphs) == 5 and graphs.stats["hits"] == 3
    stacked = TFF.init_fleet_adapters(torch.Generator().manual_seed(4), cfg, sl, 2)
    fleet = TFF.make_fleet_cached_epoch(cfg, sl, opt, 2, use_kernel=False)
    for cache in caches + caches:
        fleet(params, stacked, opt.init(stacked), cache, idx, TFF.fleet_row_tenant(2, 2))
    assert len(graphs) == 7 and graphs.stats["hits"] == 5
