"""The port's nine prompt-side CLIs (python -m vidil_tpu_torch.<cli>) against
the root CLIs of the JAX package, each pair run as subprocesses on
tests/test_pipeline_full_chain.py's workspace: the four prompt generators,
the two GPT-3 response tools and the caption, QA and VLEP evals. Every
file they write is byte-identical. The stage-1/2 inputs (frame captions,
visual tokens) come from the port's CapFilt and visual-tokenization CLIs,
whose outputs tests/test_torch_cli.py and
tests/test_torch_visual_tokenization.py hold byte-identical to the JAX
package's. The SBERT users run a tiny MPNet snapshot at their default bf16
(the port with --device cpu).
"""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_pipeline_full_chain import VIDS, ws  # noqa: F401  (the workspace fixture)
from test_torch_mpnet import write_tiny_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = "temp_0.0_gpt3_queries"

torch.set_num_threads(1)

# jsonl lines of the in-context CLI whose bf16 selection differs between the
# two packages on this workspace (the idx map and chosen samples never may).
# qa: the support set holds "what runs?" twice (video0's and video1's
# example), so for a "what sits?" query the two tie, and the last ulp of the
# cosine product, which bf16 rounding moves differently in each package,
# decides which example comes first: 2 of the 4 lines order them otherwise
BF16_DIFFERING_LINES = {"caption": 0, "qa": 2}


def _run_both(root_script, port_module, args, env=None, timeout=600):
    """Run the root CLI and the port's at once; both must exit 0. Returns
    their stdouts. `args` is a function of the side ("jax" or "port")."""
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    procs = {
        "jax": subprocess.Popen([sys.executable, os.path.join(REPO, root_script)] + args("jax"),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env, cwd=REPO),
        "port": subprocess.Popen([sys.executable, "-m", port_module] + args("port"),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=REPO),
    }
    out = {}
    for side, p in procs.items():
        stdout, stderr = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"{side} {root_script}: {stderr[-3000:]}"
        out[side] = stdout
    return out


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, name))}


def _last_number(stdout):
    return float(stdout.strip().splitlines()[-1].split()[-1])


@pytest.fixture(scope="module")
def stages(ws):  # noqa: F811
    """Frame captions and visual tokens of the workspace's three videos,
    from the port's stage-1/2 CLIs on the CPU."""
    from vidil_tpu_torch import run_video_CapFilt, run_visual_tokenization

    out = {}
    for name, cli in (("frame_caption", run_video_CapFilt),
                      ("visual_tokenization_clip", run_visual_tokenization)):
        d = str(ws.root / f"port_{name}")
        os.makedirs(d, exist_ok=True)
        cli.main(types.SimpleNamespace(output_dir=d, seed=42, world_size=1, dist_url="env://",
                                       distributed=False, device="cpu",
                                       encoder_version="clip"), dict(ws.config))
        out[name] = d
    words = {"first", "then", "after", "that", "finally", ".", ",", "?", "what", "the",
             "instruction", "caption", "answer", "question", "video", "runs", "sits"}
    for name in ("video_text_Cap.json", "video_text_CapFilt.json"):
        for caps in json.load(open(os.path.join(out["frame_caption"], name))).values():
            words |= {w.strip(".,?") for c in caps for w in c.lower().split()}
    for obj in json.load(open(os.path.join(out["visual_tokenization_clip"],
                                           "visual_tokens.json"))).values():
        for frame in obj["frame_tokens"]:
            words |= {w for terms in frame.values() for t in terms for w in t.lower().split()}
    out["sbert"] = write_tiny_snapshot(str(ws.root / "sbert"), sorted(words - {""}), seed=1)
    qa = {"video0": [{"question": "what runs?", "answer": "dog"},
                     {"question": "what sits?", "answer": "cat"}],
          "video1": [{"question": "what runs?", "answer": "dog"}],
          "video2": [{"question": "what sits?", "answer": "cat"}]}
    out["qa"] = str(ws.root / "qa.json")
    json.dump(qa, open(out["qa"], "w"))
    return types.SimpleNamespace(**out)


def _stage_args(ws, stages, side, tag, task="caption"):  # noqa: F811
    return ["--prompt_task", task,
            "--visual_tokens_dir", stages.visual_tokenization_clip,
            "--frame_captions_dir", stages.frame_caption,
            "--output_dir", str(ws.root / f"{side}_{tag}")]


def _train_args(ws, stages):  # noqa: F811
    return ["--train_dataset_visual_tokens_dir", stages.visual_tokenization_clip,
            "--train_dataset_frame_captions_dir", stages.frame_caption,
            "--trainset_json_ann", ws.ann_path, "--shot", "2", "--seed", "42"]


def _compare_dirs(ws, tag):  # noqa: F811
    want, got = _files(ws.root / f"jax_{tag}"), _files(ws.root / f"port_{tag}")
    assert got == want
    return got


def test_fixed_prefix_cli_matches_root(ws, stages):  # noqa: F811
    prefix = ws.root / "prefix.txt"
    prefix.write_text("Instruction: describe the video.\n")
    _run_both("generate_prompts_fixed_prefix.py", "vidil_tpu_torch.generate_prompts_fixed_prefix",
              lambda side: _stage_args(ws, stages, side, "fixed")
              + ["--prompt_prefix", str(prefix), "--add_scenes", "--add_events"])
    got = _compare_dirs(ws, "fixed")
    assert set(got) == {f"{QUERIES}.jsonl", f"{QUERIES}__idx_2_videoid.json"}
    assert len(got[f"{QUERIES}.jsonl"].splitlines()) == len(VIDS)


@pytest.mark.parametrize("task,extra", [("caption", []), ("caption", ["--permutate", "2"]),
                                        ("qa", [])])
def test_random_prefix_cli_matches_root(ws, stages, task, extra):  # noqa: F811
    tag = f"random_{task}_{len(extra)}"
    qa = ["--question_answer_path", stages.qa] if task == "qa" else []
    _run_both("generate_prompts_random_prefix.py", "vidil_tpu_torch.generate_prompts_random_prefix",
              lambda side: _stage_args(ws, stages, side, tag, task) + _train_args(ws, stages)
              + qa + extra + ["--instruction_line", "Instruction: caption the video."])
    got = _compare_dirs(ws, tag)
    assert f"{QUERIES}__chosen_samples.json" in got


@pytest.mark.parametrize("task,target", [("caption", "caption"), ("qa", "question")])
def test_in_context_selection_cli_bf16_matches_root(ws, stages, task, target):  # noqa: F811
    """Both CLIs at their default bf16 (the port with --device cpu): the
    idx map and chosen samples byte-identical; the jsonl lines whose
    selection differs are counted against BF16_DIFFERING_LINES."""
    tag = f"icl_{task}"
    qa = ["--question_answer_path", stages.qa] if task == "qa" else []
    _run_both("generate_prompts_random_prefix_in_context_selection.py",
              "vidil_tpu_torch.generate_prompts_random_prefix_in_context_selection",
              lambda side: _stage_args(ws, stages, side, tag, task) + _train_args(ws, stages)
              + qa + ["--instruction_line", "Instruction: answer.", "--shot", "3", "--N", "2",
                      "--comparing_target", target, "--sbert_model", stages.sbert]
              + (["--device", "cpu"] if side == "port" else []))
    want, got = _files(ws.root / f"jax_{tag}"), _files(ws.root / f"port_{tag}")
    assert set(got) == set(want) == {f"{QUERIES}.jsonl", f"{QUERIES}__idx_2_videoid.json",
                                     f"{QUERIES}__chosen_samples.json"}
    for name in (f"{QUERIES}__idx_2_videoid.json", f"{QUERIES}__chosen_samples.json"):
        assert got[name] == want[name], name
    lines = [got[f"{QUERIES}.jsonl"].splitlines(), want[f"{QUERIES}.jsonl"].splitlines()]
    assert len(lines[0]) == len(lines[1]) == (4 if task == "qa" else len(VIDS))
    assert sum(a != b for a, b in zip(*lines)) == BF16_DIFFERING_LINES[task]


def test_in_context_selection_cli_refuses_without_a_card(ws, stages, tmp_path):  # noqa: F811
    """With no --device the port's CLI asks for CUDA; on a host without it
    it fails before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "vidil_tpu_torch.generate_prompts_random_prefix_in_context_selection",
         "--visual_tokens_dir", stages.visual_tokenization_clip,
         "--frame_captions_dir", stages.frame_caption, "--output_dir", str(out),
         "--sbert_model", stages.sbert] + _train_args(ws, stages),
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not out.exists()


def test_vlep_multichoice_cli_matches_root(ws, stages):  # noqa: F811
    train_ann = {str(i): {"video_id": vid, "events": ["the dog runs", "the cat sits"],
                          "answer": ["the dog runs", "the cat sits"][i % 2]}
                 for i, vid in enumerate(VIDS)}
    target_ann = {"10": {"video_id": "video0", "events": ["the dog runs", "the cat sits"],
                         "answer": 0},
                  "11": {"video_id": "video1", "events": ["the dog runs", "the cat sits"],
                         "answer": 1}}
    json.dump(train_ann, open(ws.root / "vlep_train_ann.json", "w"))
    json.dump(target_ann, open(ws.root / "vlep_target_ann.json", "w"))
    _run_both("generate_prompts_random_prefix_vlep_multichoice.py",
              "vidil_tpu_torch.generate_prompts_random_prefix_vlep_multichoice",
              lambda side: _stage_args(ws, stages, side, "vlep", "vlep")
              + ["--train_dataset_visual_tokens_dir", stages.visual_tokenization_clip,
                 "--train_dataset_frame_captions_dir", stages.frame_caption,
                 "--trainset_json_ann", str(ws.root / "vlep_train_ann.json"),
                 "--target_json_ann", str(ws.root / "vlep_target_ann.json"),
                 "--instruction_line", "Instruction: what happens next? Pick A or B.",
                 "--shot", "2", "--seed", "42"])
    got = _compare_dirs(ws, "vlep")
    assert f"{QUERIES}__idx_2_example_id.json" in got


@pytest.fixture(scope="module")
def responses(ws, stages):  # noqa: F811
    """The random-prefix caption prompts and fake GPT-3 responses to them
    (tests/test_pipeline_full_chain.py's stage 4), by the root CLI."""
    prompts = str(ws.root / "responses_prompts")
    subprocess.run([sys.executable, os.path.join(REPO, "generate_prompts_random_prefix.py")]
                   + _stage_args(ws, stages, "x", "unused")[:6] + ["--output_dir", prompts]
                   + _train_args(ws, stages) + ["--instruction_line", "Caption it."],
                   check=True, capture_output=True, env=dict(os.environ, PYTHONPATH=REPO))
    resp_dir = ws.root / "gpt3_responses"
    resp_dir.mkdir()
    with open(resp_dir / f"{QUERIES}.jsonl", "w") as f:
        for i in range(len(VIDS)):
            f.write(json.dumps({"choices": [
                {"text": f"\na dog runs in video {i}\n\nObjects: junk"},
                {"text": "  a picture of a dog.  "}]}) + "\n")
    gt = ws.root / "gt_captions.jsonl"
    with open(gt, "w") as f:
        for vid in VIDS:
            f.write(json.dumps({"clip_name": vid, "caption": ws.ann[vid][0]}) + "\n")
    return types.SimpleNamespace(prompts=prompts, dir=str(resp_dir), gt=str(gt))


def test_gpt3_response_clis_match_root(ws, responses):  # noqa: F811
    for side in ("jax", "port"):  # the CLI writes into an existing directory
        (ws.root / f"{side}_processed").mkdir()
    _run_both("utils_gpt3/process_gpt3_response.py",
              "vidil_tpu_torch.utils_gpt3.process_gpt3_response",
              lambda side: ["--gpt3_response_dir", responses.dir,
                            "--input_prompts_dir", responses.prompts,
                            "--output_dir", str(ws.root / f"{side}_processed")])
    processed = _compare_dirs(ws, "processed")
    assert set(processed) == {f"processed_{QUERIES}.json"}
    assert set(json.loads(processed[f"processed_{QUERIES}.json"])) == set(VIDS)
    _run_both("utils_gpt3/gpt3_response_to_jsonl.py",
              "vidil_tpu_torch.utils_gpt3.gpt3_response_to_jsonl",
              lambda side: ["--gpt3_processed_dir", str(ws.root / "port_processed"),
                            "--train_ann_json", ws.ann_path,
                            "--output_dir", str(ws.root / f"{side}_pseudo")])
    pseudo = _compare_dirs(ws, "pseudo")
    assert len(pseudo[f"processed_{QUERIES}.jsonl"].splitlines()) == 2 * len(VIDS)


def test_caption_eval_cli_matches_root(ws, responses):  # noqa: F811
    _run_both("eval_video_captioning_results.py", "vidil_tpu_torch.eval_video_captioning_results",
              lambda side: ["--gpt3_response_file", os.path.join(responses.dir, f"{QUERIES}.jsonl"),
                            "--idx_2_videoid_json",
                            os.path.join(responses.prompts, f"{QUERIES}__idx_2_videoid.json"),
                            "--gt_jsonl", responses.gt,
                            "--output_dir", str(ws.root / f"{side}_caption_eval")])
    got = _compare_dirs(ws, "caption_eval")
    assert set(got) == {f"processed_{QUERIES}.json", "metric.json"}
    assert json.loads(got["metric.json"])["CIDEr"] is not None
    results = str(ws.root / f"port_caption_eval/processed_{QUERIES}.json")
    _run_both("eval_video_captioning_results.py", "vidil_tpu_torch.eval_video_captioning_results",
              lambda side: ["--results_file", results, "--gt_jsonl", responses.gt,
                            "--output_dir", str(ws.root / f"{side}_caption_eval_results")])
    _compare_dirs(ws, "caption_eval_results")


@pytest.fixture(scope="module")
def qa_eval(ws, stages):  # noqa: F811
    """tests/test_pipeline_full_chain.py's QA chain inputs: gt jsonl, fake
    GPT-3 answers, the idx map of one QA prompt run, the answer list."""
    prompts = str(ws.root / "qa_eval_prompts")
    subprocess.run([sys.executable, os.path.join(REPO, "generate_prompts_random_prefix.py")]
                   + _stage_args(ws, stages, "x", "unused", "qa")[:6]
                   + ["--output_dir", prompts, "--question_answer_path", stages.qa]
                   + _train_args(ws, stages) + ["--instruction_line", "Answer it."],
                   check=True, capture_output=True, env=dict(os.environ, PYTHONPATH=REPO))
    queries = [json.loads(line) for line in open(os.path.join(prompts, f"{QUERIES}.jsonl"))]
    raw = []
    for q in queries:
        ans = "a dog" if "runs" in q["prompt"].rsplit("Question:", 1)[-1] else "a cat"
        raw.append(json.dumps({"choices": [{"text": f"\n{ans}\n\nObjects: junk"},
                                           {"text": "not sure"}, {"text": ans + ". yes"}]}))
    gt = ws.root / "qa_gt.jsonl"
    qa = json.load(open(stages.qa))
    with open(gt, "w") as f:
        for vid, pairs in qa.items():
            for p in pairs:
                f.write(json.dumps({"video_id": vid, "question": p["question"],
                                    "answer": p["answer"]}) + "\n")
    json.dump(["dog", "cat", "man", "ball"], open(ws.root / "qa_answers.json", "w"))
    json.dump([{"question_id": i, "answer": a} for i, a in enumerate(["dog", "a cat", "dog", "x"])],
              open(ws.root / "qa_pred.json", "w"))
    return types.SimpleNamespace(raw="\n".join(raw) + "\n", gt=str(gt),
                                 idx=os.path.join(prompts, f"{QUERIES}__idx_2_videoid.json"),
                                 answers=str(ws.root / "qa_answers.json"),
                                 pred=str(ws.root / "qa_pred.json"))


@pytest.mark.parametrize("setting", ["generation_gpt3_raw", "generation_gpt3_raw_majority_vote",
                                     "generation", "ranking"])
def test_qa_eval_cli_matches_root(ws, stages, qa_eval, setting):  # noqa: F811
    """The SBERT settings read VIDIL_SBERT_MODEL; the written tmp.jsonl is
    byte-identical and the printed accuracy equal."""
    for side in ("jax", "port"):
        d = ws.root / f"{side}_qa_{setting}"
        d.mkdir()
        (d / "raw.jsonl").write_text(qa_eval.raw)

    def args(side):
        d = ws.root / f"{side}_qa_{setting}"
        common = ["--setting", setting, "--gt", qa_eval.gt, "--answer_list_json", qa_eval.answers]
        pred = (["--pred", qa_eval.pred] if setting in ("generation", "ranking") else
                ["--pred_jsonl", str(d / "raw.jsonl"), "--idx_2_video_id", qa_eval.idx])
        return common + pred + (["--device", "cpu"] if side == "port" else [])

    out = _run_both("eval_video_qa_result.py", "vidil_tpu_torch.eval_video_qa_result", args,
                    env={"VIDIL_SBERT_MODEL": stages.sbert})
    assert _last_number(out["port"]) == _last_number(out["jax"])
    got = _compare_dirs(ws, f"qa_{setting}")
    assert ("tmp.jsonl" in got) == setting.startswith("generation_gpt3_raw")


def test_vlep_eval_cli_matches_root(ws, stages):  # noqa: F811
    data = {"10": {"video_id": "video0", "events": ["the dog runs", "the cat sits"], "answer": 0},
            "11": {"video_id": "video1", "events": ["the dog runs", "the cat sits"], "answer": 1},
            "12": {"video_id": "video2", "events": ["a cat sits", "a dog runs"], "answer": 1}}
    json.dump(data, open(ws.root / "vlep_eval_ann.json", "w"))
    for kind, results in (("multichoice", {"10": "the dog runs", "11": ["the cat sits"],
                                           "12": "dog"}),
                          ("openended", {"video0": "a dog runs", "video1": ["the cat"],
                                         "video2": "a dog"})):
        for side in ("jax", "port"):
            d = ws.root / f"{side}_vlep_{kind}"
            d.mkdir()
            json.dump(results, open(d / f"processed_{kind}.json", "w"))
        out = _run_both(
            "eval_vlep.py", "vidil_tpu_torch.eval_vlep",
            lambda side: ["--gpt3_processed_response",
                          str(ws.root / f"{side}_vlep_{kind}/processed_{kind}.json"),
                          "--output_path", str(ws.root / f"{side}_vlep_{kind}/preds.jsonl"),
                          "--example_id_2_data", str(ws.root / "vlep_eval_ann.json")]
            + (["--device", "cpu"] if side == "port" else []),
            env={"VIDIL_SBERT_MODEL": stages.sbert})
        assert out["port"] == out["jax"]
        got = _compare_dirs(ws, f"vlep_{kind}")
        assert len(got["preds.jsonl"].splitlines()) == 3
