"""Shared machinery for the four prompt-generation entry points: the
port's own copy of ``vidil_tpu/pipeline/generate_prompts.py``.

Mirrors the reference generators byte-for-byte:
  generate_prompts_fixed_prefix.py
  generate_prompts_random_prefix.py
  generate_prompts_random_prefix_in_context_selection.py
  generate_prompts_random_prefix_vlep_multichoice.py

Notes on deliberately-replicated quirks:
* the three generators handle empty ASR slightly differently (fixed:
  ``asr == ''`` check; in-context: ``asr in ['', ' ']``; random/vlep: no
  check) — parameterized via ``empty_values``;
* few-shot sampling uses the host ``random`` module seeded with the CLI
  seed, sampling video ids until ``shot`` distinct ones with visual
  tokens are found (reference random_prefix:35-39);
* SBERT in-context selection keeps ``np.argsort(...)[-N:]`` order
  ("highest at the bottom", reference in_context_selection:145), one
  ``encoder([query])`` call per query as the reference makes it.

The SBERT encoder is the port's MPNet (``models/mpnet.py``) read from a
local snapshot directory, on CUDA unless the caller asks for the CPU;
there is no download route.
"""

from __future__ import annotations

import itertools
import json
import os
import random

import numpy as np

import torch

from vidil_tpu_torch.pipeline.prompts import Prompt

VLEP_SENT_ENDINGS = (".", ",", "?", ";", "!", ":", "'", '"')


def load_asr(subs, prompt_task: str, vlep_truncate: bool = True, empty_values=()):
    """subs (list of str) -> asr string (reference in_context_selection:63-85)."""
    if subs == []:
        return "no subtitle."
    if prompt_task == "vlep" and vlep_truncate:
        new_subs = []
        total_length = 0
        for sub in subs:
            sub = sub.strip()
            if not sub.endswith(VLEP_SENT_ENDINGS):
                sub += "."
            new_subs.append(sub)
            total_length += len(sub)
            if total_length >= 1024:
                break
        asr = " ".join(new_subs)
    else:
        asr = " ".join(subs)
    if asr in empty_values:
        asr = "no subtitle."
    return asr


def resolve_frame_captions(video_name, filtered, unfiltered, caption_all_video: bool):
    """Filtered captions with unfiltered fallback (reference
    fixed_prefix:31-41). Returns the dict to index with video_name, or None
    to skip the video."""
    if video_name not in filtered:
        if caption_all_video:
            if video_name not in unfiltered:
                print("skip loading failed video:", video_name)
                return None
            print(f"fallback to unfiltered: {video_name}")
            return unfiltered
        return None
    return filtered


def default_request_body(args, with_n: bool = True) -> dict:
    body = {
        "engine": "text-davinci-002",
        "prompt": "",
    }
    if with_n:
        body["n"] = args.gpt3_num_generation
    body.update({
        "temperature": args.gpt3_temperature,
        "max_tokens": args.gpt3_max_tokens,
        "top_p": args.gpt3_top_p,
        "frequency_penalty": 0,
        "presence_penalty": 0,
    })
    return body


def base_config_from_args(args, output_path: str, request_body: dict) -> dict:
    return {
        "prompt_task": args.prompt_task,
        "add_objects": args.add_objects,
        "add_events": args.add_events,
        "add_attributes": args.add_attributes,
        "add_scenes": args.add_scenes,
        "add_original_caption": args.add_original_caption,
        "add_frame_captions": args.add_frame_captions,
        "add_ASR": args.add_ASR,
        "add_answer": args.add_answer,
        "prompt_temporal_template": args.prompt_temporal_template,
        "prompt_version": "v2",
        "visual_token_aggregation_version": "v2",
        "topk": 4,
        "output_path": output_path,
        "request_body": request_body,
        "caption_all_video": args.caption_all_video,
    }


def write_jsonl_and_idx(output_lines, line_num_2_video_id, output_path: str,
                        idx_suffix: str = "__idx_2_videoid.json") -> None:
    """reference fixed_prefix:81-90 — jsonl + idx map side file."""
    with open(output_path, "w") as out:
        for line in output_lines:
            out.write(line)
            out.write("\n")
    output_name = os.path.basename(output_path)[:-6]
    output_dirname = os.path.dirname(output_path)
    with open(os.path.join(output_dirname, output_name + idx_suffix), "w") as out:
        json.dump(line_num_2_video_id, out, indent=4)


# ---------------------------------------------------------------------------
# few-shot prefix construction (random_prefix + in_context_selection)
# ---------------------------------------------------------------------------

def get_prompt_prefix(
    train_visual_tokens,
    train_frame_captions_filtered,
    train_frame_captions_unfiltered,
    training_video_ids,
    instruction_line,
    config,
    video_2_question_answer_pairs,
    video_2_asr,
    shot: int,
    seed: int,
    asr_empty_values=(),
):
    """Sample `shot` training examples and build the few-shot prefix
    (reference random_prefix:16-123, in_context_selection:19-128).

    Returns (final_prompt_prefix_strs, in_context_examples,
    chosen_few_shot_examples).
    """
    dummy_prompt = Prompt("", seed=seed)
    random.seed(seed)
    print(seed, shot)

    chosen_video_ids: list = []
    while len(chosen_video_ids) != shot:
        cand = random.choice(training_video_ids)
        if cand in train_visual_tokens and cand not in chosen_video_ids:
            chosen_video_ids.append(cand)

    chosen_few_shot_examples: dict = {}
    example_strs: list[str] = []
    for video_name in chosen_video_ids:
        visual_tokens_object = train_visual_tokens[video_name]
        frame_captions = resolve_frame_captions(
            video_name, train_frame_captions_filtered, train_frame_captions_unfiltered,
            config["caption_all_video"],
        )
        if frame_captions is None:
            continue
        if video_2_asr is not None and video_name in video_2_asr:
            asr = load_asr(video_2_asr[video_name], config["prompt_task"],
                           empty_values=asr_empty_values)
        else:
            asr = None

        if config["prompt_task"] == "qa":
            if video_name not in video_2_question_answer_pairs:
                print(f"skip video without qa annotation: {video_name}")
                continue
            item = random.choice(video_2_question_answer_pairs[video_name])
            question, answer = item["question"], item["answer"]
            prompt_str = dummy_prompt.construct_prompt(
                video_name, visual_tokens_object, frame_captions, config, question, answer, asr)
            chosen_few_shot_examples[video_name] = {"question": question, "answer": answer}
        elif config["prompt_task"] == "caption":
            prompt_str = dummy_prompt.construct_prompt(
                video_name, visual_tokens_object, frame_captions, config,
                question=None, answer=None, asr=asr)
            chosen_few_shot_examples[video_name] = [prompt_str.split("Video Caption:")[-1].strip()]
        elif config["prompt_task"] == "vlep":
            prompt_str = dummy_prompt.construct_prompt(
                video_name, visual_tokens_object, frame_captions, config,
                question=None, answer=None, asr=asr)
            chosen_few_shot_examples[video_name] = [
                prompt_str.split("What is likely to happen next?")[-1].strip()
            ]
        example_strs.append(prompt_str)

    if config.get("permutate", -1) == -1:
        in_context_examples = example_strs
        final_prompt_prefix_str = ["\n\n".join([instruction_line] + in_context_examples) + "\n\n"]
    else:
        final_prompt_prefix_str = []
        example_permutations = list(itertools.permutations(example_strs))
        random.shuffle(example_permutations)
        for i in range(config["permutate"]):
            in_context_examples = list(example_permutations[i])
            final_prompt_prefix_str.append(
                "\n\n".join([instruction_line] + in_context_examples) + "\n\n"
            )

    print(f"### {chosen_video_ids} ###")
    output_name = os.path.basename(config["output_path"])[:-6]
    output_dirname = os.path.dirname(config["output_path"])
    with open(os.path.join(output_dirname, output_name + "__chosen_samples.json"), "w") as out:
        json.dump(chosen_few_shot_examples, out, indent=4)

    return final_prompt_prefix_str, in_context_examples, chosen_few_shot_examples


# ---------------------------------------------------------------------------
# query generation
# ---------------------------------------------------------------------------

def save_prompt_lines(
    visual_tokens,
    frame_captions_filtered,
    frame_captions_unfiltered,
    prompt: Prompt,
    config,
    video_2_question_answer_pairs,
    video_2_asr,
    asr_empty_values=("",),
    vlep_truncate: bool = False,
):
    """One jsonl line per video (or per QA pair) (reference
    fixed_prefix:16-90, random_prefix:125-205)."""
    print("number of videos:", len(visual_tokens))
    output_lines: list[str] = []
    line_num_2_video_id: dict = {}
    for video_name, visual_tokens_object in visual_tokens.items():
        frame_captions = resolve_frame_captions(
            video_name, frame_captions_filtered, frame_captions_unfiltered,
            config["caption_all_video"],
        )
        if frame_captions is None:
            continue
        if video_2_asr is not None and video_name in video_2_asr:
            asr = load_asr(video_2_asr[video_name], config["prompt_task"],
                           vlep_truncate=vlep_truncate, empty_values=asr_empty_values)
        else:
            asr = None

        if config["prompt_task"] == "qa":
            if video_name not in video_2_question_answer_pairs:
                print(f"skip video without qa annotation: {video_name}")
                continue
            for qidx in range(len(video_2_question_answer_pairs[video_name])):
                item = video_2_question_answer_pairs[video_name][qidx]
                prompt_str = prompt.construct_prompt(
                    video_name, visual_tokens_object, frame_captions, config,
                    item["question"], item["answer"], asr)
                request_body = config["request_body"]
                request_body["prompt"] = prompt_str
                output_lines.append(json.dumps(request_body))
                line_num_2_video_id[len(output_lines) - 1] = (video_name, qidx)
        else:
            prompt_str = prompt.construct_prompt(
                video_name, visual_tokens_object, frame_captions, config,
                question=None, answer=None, asr=asr)
            request_body = config["request_body"]
            request_body["prompt"] = prompt_str
            output_lines.append(json.dumps(request_body))
            line_num_2_video_id[len(output_lines) - 1] = video_name

    write_jsonl_and_idx(output_lines, line_num_2_video_id, config["output_path"])


# ---------------------------------------------------------------------------
# SBERT in-context selection
# ---------------------------------------------------------------------------

def _extract_compare_str(example: str, comparing_target: str) -> str:
    """reference in_context_selection:132-142,182-192."""
    if comparing_target == "question":
        return example.split("Question: ")[1].split("\n")[0].strip()
    if comparing_target == "caption":
        return example.split("Frame Captions: ")[1].split("\n")[0].strip()
    if comparing_target == "caption_asr":
        return example.split("Frame Captions: ")[1].split("\nVideo Caption")[0].strip()
    return example


def make_sbert_encoder(model_name: str = "all-mpnet-base-v2", max_length: int = 128,
                       device="cuda", dtype=torch.bfloat16):
    """Sentence encoder for in-context selection / answer mapping
    (reference :175-179 uses SentenceTransformer on GPU).

    ``model_name`` must be a LOCAL DIRECTORY holding an MPNet checkpoint:
    ``config.json``, ``vocab.txt`` and ``pytorch_model.bin`` or
    ``model.safetensors`` (picked in that order; an HF snapshot, or a
    sentence-transformers snapshot whose model files live at the top
    level). A model name raises: the port has no download route. The
    encoder runs in `dtype` on `device` (CUDA unless the caller asks for
    the CPU; CUDA on a host without it raises).
    Returns a callable list[str] -> (n, d) float array.
    """
    from vidil_tpu_torch.models.convert import load_torch_state_dict
    from vidil_tpu_torch.models.mpnet import MPNetConfig, convert_mpnet, make_torch_sbert_encoder
    from vidil_tpu_torch.pipeline.capfilt import resolve_device
    from vidil_tpu_torch.tokenizer import MPNetTokenizer

    if not os.path.isdir(model_name):
        raise ValueError(
            f"SBERT model {model_name!r} is not a local directory: vidil_tpu_torch reads only "
            "a local MPNet snapshot (config.json, vocab.txt, pytorch_model.bin or "
            "model.safetensors), e.g. a saved all-mpnet-base-v2; pass its path "
            "(--sbert_model, or VIDIL_SBERT_MODEL for the evals)")
    device = resolve_device(device)
    root = model_name
    with open(os.path.join(root, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = MPNetConfig(
        vocab_size=hf_cfg.get("vocab_size", 30527),
        hidden_size=hf_cfg.get("hidden_size", 768),
        num_layers=hf_cfg.get("num_hidden_layers", 12),
        num_heads=hf_cfg.get("num_attention_heads", 12),
        intermediate_size=hf_cfg.get("intermediate_size", 3072),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 514),
        relative_attention_num_buckets=hf_cfg.get("relative_attention_num_buckets", 32),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=hf_cfg.get("pad_token_id", 1),
    )
    ckpt = next(
        os.path.join(root, f)
        for f in ("pytorch_model.bin", "model.safetensors")
        if os.path.exists(os.path.join(root, f))
    )
    sd = load_torch_state_dict(ckpt)
    prefix = "mpnet." if any(k.startswith("mpnet.") for k in sd) else ""
    params = convert_mpnet(sd, cfg, prefix=prefix)
    tok = MPNetTokenizer(os.path.join(root, "vocab.txt"))
    return make_torch_sbert_encoder(params, cfg, tok, max_length=max_length, dtype=dtype,
                                    device=device)


def select_from_support_set(encoder, support_embeddings, in_context_examples,
                            query_instance_str, N: int = 5,
                            comparing_target: str = "question"):
    """Top-N cosine, highest at the bottom (reference :131-148)."""
    query = _extract_compare_str(query_instance_str, comparing_target)
    q = np.asarray(encoder([query]))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s = support_embeddings / np.linalg.norm(support_embeddings, axis=-1, keepdims=True)
    cosine_scores = q @ s.T
    topn_idx = np.argsort(cosine_scores[0])[-N:]
    return [in_context_examples[j] for j in topn_idx]


def save_prompt_lines_with_in_context_selection(
    visual_tokens,
    frame_captions_filtered,
    frame_captions_unfiltered,
    N: int,
    instruction_line: str,
    in_context_examples,
    config,
    video_2_question_answer_pairs,
    video_2_asr,
    comparing_target: str = "question",
    encoder=None,
):
    """reference in_context_selection:150-287."""
    dummy_prompt = Prompt("", seed=42)
    if encoder is None:
        encoder = make_sbert_encoder()

    support_strs = [_extract_compare_str(e, comparing_target) for e in in_context_examples]
    support_embeddings = np.asarray(encoder(support_strs))

    print("number of videos:", len(visual_tokens))
    output_lines: list[str] = []
    line_num_2_video_id: dict = {}
    for video_name, visual_tokens_object in visual_tokens.items():
        frame_captions = resolve_frame_captions(
            video_name, frame_captions_filtered, frame_captions_unfiltered,
            config["caption_all_video"],
        )
        if frame_captions is None:
            continue
        if video_2_asr is not None and video_name in video_2_asr:
            asr = load_asr(video_2_asr[video_name], config["prompt_task"],
                           empty_values=("", " "))
        else:
            asr = None

        def emit(question, answer, key):
            query_instance_str = dummy_prompt.construct_prompt(
                video_name, visual_tokens_object, frame_captions, config,
                question, answer, asr)
            selected = select_from_support_set(
                encoder, support_embeddings, in_context_examples,
                query_instance_str, N=N, comparing_target=comparing_target)
            prefix = "\n\n".join([instruction_line] + selected) + "\n\n"
            prompt = Prompt(prefix, seed=42)
            prompt_str = prompt.construct_prompt(
                video_name, visual_tokens_object, frame_captions, config,
                question, answer, asr)
            request_body = config["request_body"]
            request_body["prompt"] = prompt_str
            output_lines.append(json.dumps(request_body))
            line_num_2_video_id[len(output_lines) - 1] = key

        if config["prompt_task"] == "qa":
            if video_name not in video_2_question_answer_pairs:
                print(f"skip video without qa annotation: {video_name}")
                continue
            for qidx in range(len(video_2_question_answer_pairs[video_name])):
                item = video_2_question_answer_pairs[video_name][qidx]
                emit(item["question"], item["answer"], (video_name, qidx))
        else:
            emit(None, None, video_name)

    write_jsonl_and_idx(output_lines, line_num_2_video_id, config["output_path"])


# ---------------------------------------------------------------------------
# VLEP multichoice
# ---------------------------------------------------------------------------

def get_prompt_prefix_vlep(
    train_visual_tokens,
    train_frame_captions_filtered,
    train_frame_captions_unfiltered,
    training_video_ann,
    instruction_line,
    config,
    video_2_asr,
    shot: int,
    seed: int,
):
    """reference vlep_multichoice:15-103 — example-id-keyed sampling."""
    dummy_prompt = Prompt("", seed=seed)
    random.seed(seed)
    print(seed, shot)

    training_example_ids = sorted(training_video_ann.keys())
    chosen_example_ids: list = []
    while len(chosen_example_ids) != shot:
        cand_example_id = random.choice(training_example_ids)
        cand_video_id = training_video_ann[cand_example_id]["video_id"]
        if cand_video_id in train_visual_tokens:
            chosen_example_ids.append(cand_example_id)

    chosen_few_shot_examples: dict = {}
    example_strs: list[str] = []
    for chosen_example_id in chosen_example_ids:
        video_name = training_video_ann[chosen_example_id]["video_id"]
        visual_tokens_object = train_visual_tokens[video_name]
        frame_captions = resolve_frame_captions(
            video_name, train_frame_captions_filtered, train_frame_captions_unfiltered,
            config["caption_all_video"],
        )
        if frame_captions is None:
            continue
        if video_2_asr is not None and video_name in video_2_asr:
            asr = load_asr(video_2_asr[video_name], config["prompt_task"])
        else:
            asr = None
        prompt_str = dummy_prompt.construct_prompt(
            video_name, visual_tokens_object, frame_captions, config,
            question=None, answer=None, asr=asr,
            vlep_example=training_video_ann[chosen_example_id])
        chosen_few_shot_examples[chosen_example_id] = training_video_ann[chosen_example_id]
        example_strs.append(prompt_str)

    final_prompt_prefix_str = "\n\n".join([instruction_line] + example_strs) + "\n\n"
    print(f"### {chosen_example_ids} ###")

    output_name = os.path.basename(config["output_path"])[:-6]
    output_dirname = os.path.dirname(config["output_path"])
    with open(os.path.join(output_dirname, output_name + "__chosen_samples.json"), "w") as out:
        json.dump(chosen_few_shot_examples, out, indent=4)
    return final_prompt_prefix_str


def save_prompt_lines_vlep(
    target_video_ann,
    visual_tokens,
    frame_captions_filtered,
    frame_captions_unfiltered,
    prompt: Prompt,
    config,
    video_2_asr,
):
    """reference vlep_multichoice:105-176."""
    print("number of videos:", len(visual_tokens))
    output_lines: list[str] = []
    line_num_2_example_id: dict = {}
    for example_id, ann in target_video_ann.items():
        video_name = ann["video_id"]
        visual_tokens_object = visual_tokens[video_name]
        frame_captions = resolve_frame_captions(
            video_name, frame_captions_filtered, frame_captions_unfiltered,
            config["caption_all_video"],
        )
        if frame_captions is None:
            continue
        if video_2_asr is not None and video_name in video_2_asr:
            asr = load_asr(video_2_asr[video_name], config["prompt_task"])
        else:
            asr = None
        prompt_str = prompt.construct_prompt(
            video_name, visual_tokens_object, frame_captions, config,
            question=None, answer=None, asr=asr, vlep_example=ann)
        request_body = config["request_body"]
        request_body["prompt"] = prompt_str
        output_lines.append(json.dumps(request_body))
        line_num_2_example_id[len(output_lines) - 1] = example_id

    write_jsonl_and_idx(output_lines, line_num_2_example_id, config["output_path"],
                        idx_suffix="__idx_2_example_id.json")
