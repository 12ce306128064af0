"""The port's last host modules against the JAX package's on the CPU: REC task support
(train/rec.py), data generation (train/datagen.py, cli/generate.py) over the port's
ServingEngine and over its OpenAI endpoint, the benchmark registry and queue drainer
(eval/benchmarks.py, cli/run_benchmarks.py) with the benchmark callback that now
queues through it, and the trace (utils/profiling.py; its tracer: test_torch_tracing.py). Host outputs
are held exactly equal; generated tokens only at temperature 0 (torch and JAX draw
different random numbers). Every wait has a timeout of its own.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from zoomearth_tpu.agent.processor import Processor as JProcessor
from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.cli.generate import main as jax_generate_cli
from zoomearth_tpu.eval import benchmarks as JBM
from zoomearth_tpu.eval.client import ChatClient as JChatClient
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.serve.engine import ServingEngine as JServingEngine
from zoomearth_tpu.serve.server import OpenAIServer as JOpenAIServer
from zoomearth_tpu.tokenizer import FakeTokenizer as JFakeTokenizer
from zoomearth_tpu.train import callbacks as JCB
from zoomearth_tpu.train import datagen as JDG
from zoomearth_tpu.train import rec as JREC
from zoomearth_tpu.cli.run_benchmarks import main as jax_drain
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.cli.infer import build_parser as infer_parser
from zoomearth_tpu_torch.cli.run_benchmarks import main as drain
from zoomearth_tpu_torch.config import VLMConfig as TVLMConfig
from zoomearth_tpu_torch.eval import benchmarks as BM
from zoomearth_tpu_torch.eval.client import ChatClient
from zoomearth_tpu_torch.models.params import params_from_numpy
from zoomearth_tpu_torch.serve.engine import ServingEngine
from zoomearth_tpu_torch.serve.server import OpenAIServer
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.train import callbacks as TCB
from zoomearth_tpu_torch.train import datagen as DG
from zoomearth_tpu_torch.train import rec as REC
from zoomearth_tpu_torch.utils import profiling as PF

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
TCFG = TVLMConfig.tiny()


def _port_cmd(cmd):
    return [a.replace("zoomearth_tpu.", "zoomearth_tpu_torch.") for a in cmd]


# ---------------------------------------------------------------------------
# REC task support
# ---------------------------------------------------------------------------

@pytest.fixture
def yaml_spec(tmp_path):
    rows1 = [{"problem": f"p{i}", "solution": f"s{i}", "image": f"im{i}.png"} for i in range(10)]
    rows2 = [{"problem": f"q{i}", "solution": f"t{i}"} for i in range(4)]
    with open(tmp_path / "a.jsonl", "w") as f:
        for r in rows1:
            f.write(json.dumps(r) + "\n")
    with open(tmp_path / "b.json", "w") as f:
        json.dump(rows2, f)
    spec = tmp_path / "data.yaml"
    spec.write_text(
        "datasets:\n"
        f"  - json_path: {tmp_path}/a.jsonl\n"
        "    sampling_strategy: first:3\n"
        f"  - json_path: {tmp_path}/b.json\n"
        "    sampling_strategy: end:50%\n"
        f"  - json_path: {tmp_path}/a.jsonl\n"
        "    sampling_strategy: random:4\n"
        f"  - json_path: {tmp_path}/b.json\n"
    )
    return spec


def test_rec_yaml_datasets_equal_reference(yaml_spec, tmp_path):
    for seed in (None, 1, 7):
        ours = REC.load_yaml_datasets(str(yaml_spec), image_root="/imgs", seed=seed)
        theirs = JREC.load_yaml_datasets(str(yaml_spec), image_root="/imgs", seed=seed)
        if seed is None:  # an unseeded random strategy draws differently each call
            ours, theirs = ours[:5] + ours[9:], theirs[:5] + theirs[9:]
        assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    samples = REC.load_yaml_datasets(str(yaml_spec), image_root="/imgs", seed=1)
    assert len(samples) == 3 + 2 + 4 + 4
    assert samples[0].image_path == "/imgs/im0.png" and samples[3].problem == "q2" and samples[3].image_path is None
    for mod in (REC, JREC):
        with pytest.raises(ValueError, match="Unsupported file type"):
            mod.load_yaml_datasets(str(tmp_path / "x.txt"))
    bad = tmp_path / "bad.yaml"
    bad.write_text(f"datasets:\n  - json_path: {tmp_path}/a.csv\n")
    for mod in (REC, JREC):
        with pytest.raises(ValueError, match="Unsupported file type"):
            mod.load_yaml_datasets(str(bad))


_REC_COMPLETIONS = [
    '<think>looking</think><answer>{"bbox_2d": [1, 2, 3, 4]}</answer>', "<answer>[1,2]</answer>",
    "<think>x</think><answer>{[0, 0, 14, 14]}</answer>", "no box", "<think>a</think> <answer>{[5,6, 20,28]}</answer>",
    "<answer>[0, 0, 28, 28]</answer>", "<think>\n</think>\n<answer>\n{\"b\": [3, 3, 3, 3]}\n</answer>",
]
_REC_SOLUTIONS = ["junk", "<answer>[0,0,10,10]</answer>", "<answer>[0, 0, 140, 140]</answer>",
                  "<answer>[10, 20, 200, 280]</answer>", "<answer>[50, 60, 200, 280]</answer>",
                  "<answer>[0, 0, 280, 280]</answer>", "<answer>[30, 30, 31, 31]</answer>"]


def test_rec_rewards_prompt_and_resize_equal_reference():
    assert REC.rec_format_reward(_REC_COMPLETIONS) == JREC.rec_format_reward(_REC_COMPLETIONS)
    assert REC.rec_format_reward(_REC_COMPLETIONS[:2]) == [1.0, 0.0]
    kw = dict(image_grid_thw=[(1, 2, 2), (1, 2, 2), (1, 2, 2), (1, 4, 2), (1, 2, 4), (1, 2, 2), (1, 2, 2)],
              image_sizes=[(280, 280), (28, 28), (280, 280), (280, 560), (560, 280), (280, 280), (100, 50)])
    ours = REC.rec_iou_reward(_REC_COMPLETIONS, _REC_SOLUTIONS, **kw)
    assert ours == JREC.rec_iou_reward(_REC_COMPLETIONS, _REC_SOLUTIONS, **kw)
    assert ours[2] > 0.9 and ours[3] == 0.0 and ours[4] == 1.0
    for box, sizes in (([14, 14, 28, 28], (28, 28, 280, 280)), ([3, 5, 7, 11], (56, 28, 1000, 333))):
        assert REC.resize_bbox(box, *sizes) == JREC.resize_bbox(box, *sizes)
    for q in ("where is the car?", ""):
        assert REC.rec_prompt(q) == JREC.rec_prompt(q)
    assert REC.REC_QUESTION_TEMPLATE == JREC.REC_QUESTION_TEMPLATE
    for name in ("_REC_FORMAT_RE", "_ANSWER_TAG_RE", "_BBOX_RE"):
        assert getattr(REC, name).pattern == getattr(JREC, name).pattern
    assert [f.name for f in dataclasses.fields(REC.RECSample)] == [f.name for f in dataclasses.fields(JREC.RECSample)]


# ---------------------------------------------------------------------------
# data generation
# ---------------------------------------------------------------------------

PROMPTS = ["describe the scene", "count the ships", "name the terrain"]
_ENGINE_KW = dict(max_slots=4, max_seq_len=192, decode_chunk=2, cache_dtype="float32", length_buckets=(64, 128),
                  patch_buckets=(0, 16))


@pytest.fixture(scope="module")
def stack():
    jparams = jax_init_vlm_params(jax.random.key(0), CFG)
    engine = ServingEngine(params_from_numpy(jax.tree.map(np.asarray, jparams)), TCFG, **_ENGINE_KW)
    proc = Processor(FakeTokenizer(TCFG.tokens), TCFG, max_pixels=4 * 28 * 28)
    srv = OpenAIServer(engine, proc, port=0)
    srv.start()
    jengine = JServingEngine(jparams, CFG, **_ENGINE_KW)
    jproc = JProcessor(JFakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)
    jsrv = JOpenAIServer(jengine, jproc, port=0)
    jsrv.start()
    yield engine, proc, srv, jengine, jproc, jsrv
    jsrv.stop()
    srv.stop()


def test_engine_backend_greedy_records_equal_reference(stack):
    engine, proc, _, jengine, jproc, _ = stack
    kw = dict(num_generations=2, max_new_tokens=5, temperature=0.0, model_name="tiny", timeout=120.0)
    ours = DG.generate_records(PROMPTS, engine=engine, processor=proc, **kw)
    theirs = JDG.generate_records(PROMPTS, engine=jengine, processor=jproc, **kw)
    assert ours == theirs
    assert all(r["generations"][0] == r["generations"][1] for r in ours)  # greedy: deterministic
    assert engine.stats.get("errors", 0) == 0


def test_engine_backend_sampled_shapes(stack):
    engine, proc, *_ = stack
    recs = DG.generate_records(PROMPTS, engine=engine, processor=proc, num_generations=2, max_new_tokens=5,
                               temperature=0.9, top_p=0.9, model_name="tiny", timeout=120.0)
    assert [r["instruction"] for r in recs] == PROMPTS
    for r in recs:
        assert len(r["generations"]) == 2 and all(isinstance(g, str) for g in r["generations"])
        assert (r["model_name"], r["num_generations"], r["temperature"], r["top_p"]) == ("tiny", 2, 0.9, 0.9)


def test_client_backend_against_the_ports_server_equals_reference(stack):
    """The port's client on the port's endpoint gives the records the reference's client
    gives on the reference's endpoint over the same weights (temperature 0)."""
    *_, srv, _, _, jsrv = stack
    kw = dict(num_generations=2, max_new_tokens=4, temperature=0.0, concurrency=2)
    ours = DG.generate_records(PROMPTS[:2], client=ChatClient(f"http://127.0.0.1:{srv.port}", timeout=120.0), **kw)
    theirs = JDG.generate_records(PROMPTS[:2], client=JChatClient(f"http://127.0.0.1:{jsrv.port}", timeout=120.0),
                                  **kw)
    assert ours == theirs and all(len(r["generations"]) == 2 for r in ours)


def test_backend_selection_errors_equal_reference(stack):
    engine, *_ = stack
    for mod in (DG, JDG):
        for kw, match in (({}, "exactly one backend"), ({"engine": engine, "client": object()}, "exactly one backend"),
                          ({"engine": engine}, "needs processor")):
            with pytest.raises(ValueError, match=match):
                mod.generate_records(PROMPTS, **kw)


def test_generate_cli_end_to_end_equals_reference(stack, tmp_path):
    from zoomearth_tpu_torch.cli.generate import main as cli_main

    *_, srv, _, _, jsrv = stack
    src = tmp_path / "prompts.jsonl"
    with open(src, "w") as f:
        for p in PROMPTS:
            f.write(json.dumps({"prompt": p}) + "\n")
    rows = []
    for main, port, out in ((cli_main, srv.port, tmp_path / "out.jsonl"), (jax_generate_cli, jsrv.port,
                                                                            tmp_path / "ref.jsonl")):
        main(["--dataset", str(src), "--out", str(out), "--server-url", f"http://127.0.0.1:{port}",
              "--num-generations", "2", "--max-new-tokens", "4", "--temperature", "0", "--concurrency", "2",
              "--limit", "2", "--model", "tiny"])
        rows.append([json.loads(line) for line in open(out)])
    assert rows[0] == rows[1] and len(rows[0]) == 2 and all(len(r["generations"]) == 2 for r in rows[0])


def test_write_records_equal_reference(tmp_path):
    recs = [{"instruction": "a", "generations": ["x", "é"], "model_name": "m", "num_generations": 2,
             "max_new_tokens": 4, "temperature": 0.0, "top_p": 1.0}]
    ours = DG.write_records(recs, str(tmp_path / "d" / "r.jsonl"))
    theirs = JDG.write_records(recs, str(tmp_path / "e" / "r.jsonl"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert [json.loads(line) for line in open(ours)] == recs


# ---------------------------------------------------------------------------
# benchmark registry, queue drainer, benchmark callback
# ---------------------------------------------------------------------------

@pytest.fixture
def custom_suite():
    """A suite registered in both packages' registries, score=False."""
    kw = dict(data_file="x.jsonl", image_folder="im", extra_infer_args=("--limit", "8"), score=False)
    BM.register_benchmark("custom_suite_t", **kw)
    JBM.register_benchmark("custom_suite_t", **kw)
    yield "custom_suite_t"
    BM.BENCHMARKS.pop("custom_suite_t")
    JBM.BENCHMARKS.pop("custom_suite_t")


def _strip(job):
    return {k: v for k, v in job.items() if k != "created_at"}


def test_registry_and_build_job_equal_reference(custom_suite, tmp_path):
    assert BM.get_benchmarks() == JBM.get_benchmarks()
    assert BM.BENCHMARKS == {n: BM.BenchmarkSpec(**dataclasses.asdict(s)) for n, s in JBM.BENCHMARKS.items()}
    for name in BM.get_benchmarks():
        for kw in ({}, {"data_file": "/my/test.jsonl", "image_folder": "/my/imgs", "out_dir": str(tmp_path)}):
            ours, theirs = BM.build_job(name, "/ckpt/step50", step=50, **kw), JBM.build_job(name, "/ckpt/step50",
                                                                                            step=50, **kw)
            assert ours["cmd"][1:3] == ["-m", "zoomearth_tpu_torch.cli.infer"]
            expect = {**_strip(theirs), "cmd": _port_cmd(theirs["cmd"])}
            if "score_cmd" in theirs:
                expect["score_cmd"] = _port_cmd(theirs["score_cmd"])
            assert _strip(ours) == expect
    job = BM.build_job(custom_suite, "/ckpt/step50", step=50)
    assert "--limit" in job["cmd"] and "8" in job["cmd"] and "score_cmd" not in job


def test_run_benchmark_jobs_queues_as_the_reference(custom_suite, tmp_path):
    for names in (["all"], ["lrs_gro"], [custom_suite, "lrs_gro_mini"]):
        out = tmp_path / "-".join(names)
        ours = BM.run_benchmark_jobs(names, "/ckpt/step10", step=10, output_dir=str(out), data_file="/d.jsonl")
        rows = [json.loads(line) for line in (out / "benchmark_jobs.jsonl").read_text().splitlines()]
        (out / "benchmark_jobs.jsonl").unlink()
        theirs = JBM.run_benchmark_jobs(names, "/ckpt/step10", step=10, output_dir=str(out), data_file="/d.jsonl")
        assert [_strip(r) for r in rows] == [_strip(j) for j in ours]
        assert [j["benchmark"] for j in ours] == [j["benchmark"] for j in theirs]
        for a, b in zip(ours, theirs):
            assert a["cmd"] == _port_cmd(b["cmd"]) and a.get("score_cmd") == (
                _port_cmd(b["score_cmd"]) if "score_cmd" in b else None)
    for mod in (BM, JBM):
        with pytest.raises(ValueError, match=r"unknown benchmark\(s\) \['nope'\]"):
            mod.run_benchmark_jobs(["nope"], "/ckpt", output_dir=str(tmp_path))


def test_job_cmds_parse_with_the_ports_infer_cli_and_score_what_it_writes(tmp_path):
    parser = infer_parser()
    for name in BM.get_benchmarks():
        job = BM.build_job(name, "/ckpt/step1", step=1, out_dir=str(tmp_path))
        args = parser.parse_args(job["cmd"][3:])  # strip: python -m module
        assert args.model_name == "/ckpt/step1" and args.device == "cuda"
        written = f"{args.out_dir}/{args.exp_name}{args.rank}.jsonl"
        assert job["score_cmd"][job["score_cmd"].index("--results_file") + 1] == written


def test_benchmark_callback_queues_a_registered_suite_as_the_reference(custom_suite, tmp_path):
    """The repaired callback: a suite added with register_benchmark and its score=False
    spec reach the port's queue exactly as the JAX callback queues them."""
    out = tmp_path / "jobs"
    kw = dict(output_dir=str(out), data_file="d.jsonl", image_folder="imgs", benchmarks=(custom_suite, "lrs_gro"))
    JCB.BenchmarkCallback(**kw).on_save(50, "ckpt-50")
    theirs = [json.loads(line) for line in (out / "benchmark_jobs.jsonl").read_text().splitlines()]
    (out / "benchmark_jobs.jsonl").unlink()
    TCB.run_callbacks([TCB.BenchmarkCallback(**kw)], 50, "ckpt-50")
    ours = [json.loads(line) for line in (out / "benchmark_jobs.jsonl").read_text().splitlines()]
    assert [j["benchmark"] for j in ours] == [custom_suite, "lrs_gro"]
    assert "score_cmd" not in ours[0] and "score_cmd" in ours[1]
    for a, b in zip(ours, theirs):
        expect = {**_strip(b), "cmd": _port_cmd(b["cmd"])}
        if "score_cmd" in b:
            expect["score_cmd"] = _port_cmd(b["score_cmd"])
        assert _strip(a) == expect
    assert not hasattr(TCB, "BENCHMARKS")  # one registry: eval.benchmarks


def _queue(tmp_path, job):
    queue = tmp_path / "benchmark_jobs.jsonl"
    queue.write_text(json.dumps(job) + "\n")
    return queue


def _drain_both(tmp_path, job, extra=()):
    """Run the port's drainer and the reference's on the same job, each with its own
    queue and ledger. Returns (our records, their records) without the times."""
    recs = []
    for name, fn in (("ours", drain), ("theirs", jax_drain)):
        d = tmp_path / name
        d.mkdir()
        fn(["--queue", str(_queue(d, job)), *extra])
        fn(["--queue", str(_queue(d, job)), *extra])  # idempotent: nothing runs again
        lines = (d / "benchmark_results.jsonl").read_text().splitlines()
        recs.append([{k: v for k, v in json.loads(line).items() if k not in ("wall_s", "finished_at")}
                     for line in lines])
    return recs


def test_queue_drainer_equals_reference(tmp_path, capsys):
    marker = tmp_path / "ran.txt"
    job = {"benchmark": "fake", "step": 7, "checkpoint": "/ckpt",
           "cmd": [sys.executable, "-c", f"open({str(marker)!r}, 'a').write('infer\\n')"],
           "score_cmd": [sys.executable, "-c", f"open({str(marker)!r}, 'a').write('score\\n')"]}
    ours, theirs = _drain_both(tmp_path, job)
    assert ours == theirs and len(ours) == 1 and ours[0]["ok"] and ours[0]["rcs"] == [0, 0]
    assert marker.read_text() == "infer\nscore\n" * 2  # once by each drainer
    drain(["--queue", str(tmp_path / "ours" / "benchmark_jobs.jsonl"), "--dry_run"])
    assert "0 pending job(s) (1 already done)" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["failed infer skips score", "timeout is ledgered"])
def test_queue_drainer_failures_equal_reference(tmp_path, case):
    marker = tmp_path / "ran.txt"
    score = [sys.executable, "-c", f"open({str(marker)!r}, 'a').write('score\\n')"]
    if case == "failed infer skips score":
        job, extra, rcs = ({"benchmark": "bad", "step": 1, "checkpoint": "/c", "score_cmd": score,
                            "cmd": [sys.executable, "-c", "import sys; sys.exit(2)"]}, (), [2])
    else:
        job, extra, rcs = ({"benchmark": "hang", "step": 1, "checkpoint": "/c",
                            "cmd": [sys.executable, "-c", "import time; time.sleep(30)"]}, ("--timeout", "1"), [-9])
    ours, theirs = _drain_both(tmp_path, job, extra)
    assert ours == theirs and len(ours) == 1 and ours[0]["ok"] is False and ours[0]["rcs"] == rcs
    assert not marker.exists()


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_the_annotated_region_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with PF.trace(str(log_dir)):
        with PF.annotate("internvl_prefill"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(log_dir / files[0]))["traceEvents"]
    assert any(e.get("name") == "internvl_prefill" for e in events)
