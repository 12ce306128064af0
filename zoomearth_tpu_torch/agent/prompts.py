"""ZoomEarth prompt templates — byte-exact copies of the reference's chat-format strings.

These strings are part of the model contract (the released checkpoint was trained on
them), so they are reproduced verbatim from the reference:
- PREFIX / INSTRUCTION: src/demo.py:96-124 == src/eval/infer.py:180-209 == the LRS_GRO
  template in vlm_modules/qwen_module.py:85-114 (modulo brace escaping).
- Stage-2 continuation: prompt1 + stage1_output.split("<answer>")[0] + vision tokens
  (demo.py:142, infer.py:227) — the assistant turn continues after a mid-turn image.
"""

from __future__ import annotations

VISION_TOKENS = "<|vision_start|><|image_pad|><|vision_end|>"

PREFIX = """
<|im_start|>system
You are a helpful assistant. <|im_end|>
<|im_start|>user
<|vision_start|><|image_pad|><|vision_end|>"""

INSTRUCTION = """
You are an intelligent remote sensing analyst.
Given a natural language question about a satellite image, generate a structured reasoning answer as follows:
1. <think> ... </think>
    - Provide a neutral one-sentence description of the whole image scene.
    - Cropping task: "This question is asking about <short intent>, therefore I need to crop the image to examine the surroundings of the mentioned target."
    - Non-cropping task: "This question is asking about <short intent>, therefore I need to analyze the entire image without cropping."
    - Include:
        * Question Intent: describe the type of question (object category, spatial relation, count, etc.) and needed visual info.
        * Localization Strategy:
            - Cropping: approximate referent object location in natural language (no coordinates).
            - Non-cropping: strategy to detect all relevant objects.      * Reasoning Result:
    - Cropping: output exactly one JSON-formatted bbox for the referent:          [{"bbox_2d": [x_min,y_min,x_max,y_max], "label": "<short description>"}]
    - Non-cropping: summarize how detected objects will be used to produce the count.
2. <think> ... </think> (only when saw the cropped image)
    - Explain how to reason step by step from the referent (or detected objects) to the final answer.
3. <answer> ... </answer>
    - Your final answer, use a single word or phrase.
Rules:
    - Always return exactly one <answer> block, for tasks that need cropping, you can provide the bounding box of the object you are intrested, after given the cropped image, you can generate another <think> block to find the answer.
    - If unsure about localization, make a best guess—never say uncertain.
<|im_end|><|im_start|>assistant
"""

# The reference INSTRUCTION contains one more rule line ("For cropping tasks, also
# include a bounidng box in <stage_2_reasoning> block") in demo.py/infer.py but the
# qwen_module RL template drops nothing — keep the full eval variant:
INSTRUCTION_EVAL = """
You are an intelligent remote sensing analyst.
Given a natural language question about a satellite image, generate a structured reasoning answer as follows:
1. <think> ... </think>
    - Provide a neutral one-sentence description of the whole image scene.
    - Cropping task: "This question is asking about <short intent>, therefore I need to crop the image to examine the surroundings of the mentioned target."
    - Non-cropping task: "This question is asking about <short intent>, therefore I need to analyze the entire image without cropping."
    - Include:
        * Question Intent: describe the type of question (object category, spatial relation, count, etc.) and needed visual info.
        * Localization Strategy:
            - Cropping: approximate referent object location in natural language (no coordinates).
            - Non-cropping: strategy to detect all relevant objects.      * Reasoning Result:
    - Cropping: output exactly one JSON-formatted bbox for the referent:          [{"bbox_2d": [x_min,y_min,x_max,y_max], "label": "<short description>"}]
    - Non-cropping: summarize how detected objects will be used to produce the count.
2. <think> ... </think> (only when saw the cropped image)
    - Explain how to reason step by step from the referent (or detected objects) to the final answer.
3. <answer> ... </answer>
    - Your final answer, use a single word or phrase.
Rules:
    - Always return exactly one <answer> block, for tasks that need cropping, you can provide the bounding box of the object you are intrested, after given the cropped image, you can generate another <think> block to find the answer.
    - For cropping tasks, also include a bounidng box in <stage_2_reasoning> block
    - If unsure about localization, make a best guess—never say uncertain.
<|im_end|><|im_start|>assistant
"""


def stage1_prompt(question: str) -> str:
    """PREFIX + question + INSTRUCTION (infer.py:211: `prefix + cur_prompt + instruction`)."""
    return PREFIX + question + INSTRUCTION_EVAL


def rl_prompt(question: str) -> str:
    """The LRS_GRO RL training template (qwen_module.py:85-114): same PREFIX/body but
    WITHOUT the <stage_2_reasoning> rule line and with a newline before the assistant
    turn ("<|im_end|>\\n<|im_start|>assistant\\n")."""
    body = INSTRUCTION.rsplit("<|im_end|>", 1)[0]
    return PREFIX + question + body + "<|im_end|>\n<|im_start|>assistant\n"


TEXT_SYSTEM_PROMPT = (
    "A conversation between User and Assistant. The user asks a question, and the Assistant solves it. The assistant "
    "first thinks about the reasoning process in the mind and then provides the user with the answer. The reasoning "
    "process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively, i.e., "
    "<think> reasoning process here </think><answer> answer here </answer>"
)


def text_rl_prompt(question: str) -> str:
    """Text-only (imageless) GRPO prompt — the legacy open-r1 text path
    (reference grpo.py:118-142: SYSTEM_PROMPT system turn + question user turn),
    rendered in the Qwen chat format."""
    return (
        "<|im_start|>system\n" + TEXT_SYSTEM_PROMPT + "<|im_end|>\n"
        "<|im_start|>user\n" + question + "<|im_end|>\n<|im_start|>assistant\n"
    )


def stage2_prompt(prompt1: str, stage1_output: str, vision_tokens: str = VISION_TOKENS) -> str:
    """Continue the assistant turn with the pre-<answer> reasoning and a second image
    (infer.py:227)."""
    return prompt1 + stage1_output.split("<answer>")[0] + vision_tokens


# Kimi-VL's chat format (its tokenizer's chat template): a turn is
# <|im_ROLE|>ROLE<|im_middle|>...<|im_end|>, an image <|media_start|>image<|media_content|>
# <|media_pad|><|media_end|>. The ZoomEarth instruction is the same text.
KIMI_VISION_TOKENS = "<|media_start|>image<|media_content|><|media_pad|><|media_end|>"
KIMI_PREFIX = ("<|im_system|>system<|im_middle|>You are a helpful assistant<|im_end|>"
               "<|im_user|>user<|im_middle|>" + KIMI_VISION_TOKENS)
KIMI_ASSISTANT = "<|im_end|><|im_assistant|>assistant<|im_middle|>"


def kimi_stage1_prompt(question: str) -> str:
    """stage1_prompt in Kimi-VL's chat format: the same question and instruction, the
    user turn closed and the assistant turn opened with Kimi-VL's markers."""
    return KIMI_PREFIX + question + INSTRUCTION_EVAL.rsplit("<|im_end|>", 1)[0] + KIMI_ASSISTANT

