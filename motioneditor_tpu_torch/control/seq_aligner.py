"""Token-sequence alignment for prompt-to-prompt editing (port of
motioneditor_tpu/control/seq_aligner.py, kept as its own copy).

Needleman-Wunsch global alignment of two prompts' token ids gives the
refinement mapper; the word-level replacement mapper matches words of two
prompts of the same length. Pure numpy: the controllers
(control/p2p.py) turn the arrays into tensors on the device that runs them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class ScoreParams:
    def __init__(self, gap: int = 1, match: int = 1, mismatch: int = -1):
        self.gap = gap
        self.match = match
        self.mismatch = mismatch

    def mis_match_char(self, x, y):
        return self.match if x == y else self.mismatch


def global_align(x: Sequence[int], y: Sequence[int], score: ScoreParams):
    """Needleman-Wunsch with traceback matrix."""
    matrix = np.zeros((len(x) + 1, len(y) + 1), dtype=np.int32)
    trace_back = np.zeros((len(x) + 1, len(y) + 1), dtype=np.int32)
    matrix[:, 0] = np.arange(len(x) + 1) * score.gap
    matrix[0, :] = np.arange(len(y) + 1) * score.gap
    trace_back[1:, 0] = 1
    trace_back[0, 1:] = 2
    for i in range(1, len(x) + 1):
        for j in range(1, len(y) + 1):
            left = matrix[i, j - 1] + score.gap
            up = matrix[i - 1, j] + score.gap
            diag = matrix[i - 1, j - 1] + score.mis_match_char(x[i - 1], y[j - 1])
            matrix[i, j] = max(left, up, diag)
            if matrix[i, j] == left:
                trace_back[i, j] = 2
            elif matrix[i, j] == up:
                trace_back[i, j] = 1
            else:
                trace_back[i, j] = 3
    return matrix, trace_back


def get_aligned_sequences(x, y, trace_back):
    x_seq, y_seq = [], []
    i, j = len(x), len(y)
    mapper_y_to_x = []
    while i > 0 or j > 0:
        if trace_back[i, j] == 3:
            x_seq.append(x[i - 1])
            y_seq.append(y[j - 1])
            i -= 1
            j -= 1
            mapper_y_to_x.append((j, i))
        elif trace_back[i, j] == 1:
            x_seq.append(x[i - 1])
            y_seq.append(-1)
            i -= 1
        elif trace_back[i, j] == 2:
            x_seq.append(-1)
            y_seq.append(y[j - 1])
            j -= 1
            mapper_y_to_x.append((j, -1))
        else:
            break
    mapper_y_to_x.reverse()
    return x_seq[::-1], y_seq[::-1], np.asarray(mapper_y_to_x, np.int64)


def get_mapper(x_ids: List[int], y_ids: List[int], max_len: int = 77):
    """(mapper, alphas) for one prompt pair."""
    score = ScoreParams(0, 1, -1)
    _, trace_back = global_align(x_ids, y_ids, score)
    _, _, mapper_base = get_aligned_sequences(x_ids, y_ids, trace_back)
    alphas = np.ones(max_len, np.float32)
    alphas[: mapper_base.shape[0]] = (mapper_base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, np.int64)
    mapper[: mapper_base.shape[0]] = np.where(
        mapper_base[:, 1] == -1, -1, mapper_base[:, 1]
    )
    mapper[mapper_base.shape[0] :] = len(y_ids) + np.arange(max_len - len(y_ids))
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer, max_len: int = 77):
    """Mapper + alphas for prompt refinement."""
    x_seq = tokenizer.encode(prompts[0])
    mappers, alphas = [], []
    for p in prompts[1:]:
        y_seq = tokenizer.encode(p)
        mapper, alpha = get_mapper(x_seq, y_seq, max_len)
        mappers.append(mapper)
        alphas.append(alpha)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token indices of a word."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, w in enumerate(split_text) if word_place == w]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        words_encode = [
            tokenizer.decode([item]).strip("#") for item in tokenizer.encode(text)
        ][1:-1]
        cur_len, ptr = 0, 0
        for i in range(len(words_encode)):
            cur_len += len(words_encode[i])
            if ptr in word_place:
                out.append(i + 1)
            if cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.asarray(out, np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = 77) -> np.ndarray:
    """Word-level replacement matrix between two same-length prompts."""
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit can only be applied on prompts with the"
            " same length"
        )
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), np.float32)
    i = j = 0
    cur_inds = 0
    while i < max_len and j < max_len:
        if cur_inds < len(inds_source) and inds_source[cur_inds][0] == i:
            inds_source_, inds_target_ = inds_source[cur_inds], inds_target[cur_inds]
            if len(inds_source_) == len(inds_target_):
                mapper[inds_source_, inds_target_] = 1
            else:
                ratio = 1 / len(inds_target_)
                for i_t in inds_target_:
                    mapper[inds_source_, i_t] = ratio
            cur_inds += 1
            i += len(inds_source_)
            j += len(inds_target_)
        elif cur_inds < len(inds_source):
            mapper[i, j] = 1
            i += 1
            j += 1
        else:
            mapper[j, j] = 1
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer, max_len: int = 77):
    x_seq = prompts[0]
    return np.stack(
        [get_replacement_mapper_(x_seq, p, tokenizer, max_len) for p in prompts[1:]]
    )
