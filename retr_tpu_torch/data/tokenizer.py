"""BERT-compatible WordPiece tokenizer (a copy of retr_tpu/data/tokenizer.py).

The reference loads HuggingFace's pretrained ``bert-base-uncased`` BertTokenizer over
the network (data_utils/refcoco.py:93-94, eval_utils/decode.py:6-10). This
implementation is a from-scratch, dependency-free equivalent of the same algorithm —
basic tokenization (clean, lowercase, accent-strip, punctuation split, CJK isolation)
followed by greedy longest-match WordPiece — driven by a ``vocab.txt`` file with the
standard layout ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103 for the real
BERT vocab). Point ``Config.vocab_file`` at a real bert-base-uncased vocab.txt for
drop-in parity; tests use a synthetic vocab.

API mirrors what the reference uses: ``encode_plus`` (max_length padding/truncation,
inverted-mask output handled by the dataset), ``encode``, ``decode``/``batch_decode``
with HF-style wordpiece merging and punctuation cleanup, ``convert_tokens_to_ids``,
and the special-token attributes consumed by engine.py:146-148.

``encode_plus`` of ASCII text runs in the C++ WordPiece core
(retr_tpu_torch.native, ``tokenizer.cc``) where it loads; the Python code is
the spec it matches and the path for any other text.
"""

from __future__ import annotations

import os
import tempfile
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

from retr_tpu_torch import native


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 max_input_chars_per_word: int = 100, vocab_path: str = ""):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token, self.cls_token, self.sep_token = self.PAD, self.CLS, self.SEP
        self.unk_token, self.mask_token = self.UNK, self.MASK
        # HF-compatible private aliases used by the reference (decode.py:8-9)
        self._cls_token, self._sep_token, self._pad_token = self.CLS, self.SEP, self.PAD
        # the C++ core, attached on first use: None = untried, False = unavailable
        self._vocab_path = vocab_path
        self._native = None

    # -- construction ---------------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, do_lower_case, vocab_path=path)

    @classmethod
    def synthetic(cls, words: Iterable[str], vocab_size: Optional[int] = None) -> "WordPieceTokenizer":
        """Build a test vocab: specials at the BERT ids (PAD=0, UNK=100, CLS=101,
        SEP=102, MASK=103), whole words and their pieces after."""
        vocab = {cls.PAD: 0, cls.UNK: 100, cls.CLS: 101, cls.SEP: 102, cls.MASK: 103}
        nxt = 104
        for i in range(1, 100):
            vocab[f"[unused{i}]"] = i
        for w in words:
            # sorted: set iteration order depends on the per-process string hash
            # seed, which would make the vocab (id -> piece mapping) differ across
            # processes — a checkpoint trained in one process would mis-decode in
            # another. Sorting pins the assignment.
            for piece in sorted({w} | {w[:k] for k in range(1, len(w))} | {"##" + w[k:] for k in range(1, len(w))}):
                if piece not in vocab:
                    vocab[piece] = nxt
                    nxt += 1
        if vocab_size is not None:
            while nxt < vocab_size:
                vocab[f"[pad{nxt}]"] = nxt
                nxt += 1
        return cls(vocab)

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    # -- basic tokenization ---------------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text) if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, word: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in word:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
        )
        tokens: List[str] = []
        for word in text.split():
            if self.do_lower_case:
                word = self._strip_accents(word.lower())
            tokens.extend(self._split_punct(word))
        return tokens

    # -- wordpiece ------------------------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.UNK]
        out: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.UNK]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        return [p for w in self.basic_tokenize(text) for p in self.wordpiece(w)]

    # -- ids ------------------------------------------------------------------------
    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.vocab[self.UNK])
        return [self.vocab.get(t, self.vocab[self.UNK]) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.UNK) for i in ids]

    def encode(self, text: str, max_length: Optional[int] = None, truncation: bool = True) -> List[int]:
        ids = [self.vocab[self.CLS]] + self.convert_tokens_to_ids(self.tokenize(text)) + [self.vocab[self.SEP]]
        if max_length is not None and truncation and len(ids) > max_length:
            # HF truncation keeps [CLS] ... [SEP] within max_length
            ids = ids[: max_length - 1] + [self.vocab[self.SEP]]
        return ids

    def _native_encoder(self) -> Optional["native.NativeWordPiece"]:
        """The C++ WordPiece core on this vocabulary, attached on first use; a
        vocabulary built in memory goes to it through a temporary file that is
        removed once read. None where the library is unavailable; any other
        failure raises."""
        if self._native is None:
            if not native.available("tokenizer"):
                self._native = False
            elif self._vocab_path:
                self._native = native.NativeWordPiece(self._vocab_path)
            else:
                fd, path = tempfile.mkstemp(suffix=".vocab.txt")
                try:
                    with os.fdopen(fd, "w", encoding="utf-8") as f:
                        for i in range(self.vocab_size):
                            f.write(self.ids_to_tokens.get(i, f"[unused_slot_{i}]") + "\n")
                    self._native = native.NativeWordPiece(path)
                finally:
                    os.unlink(path)
        return self._native or None

    def encode_plus(self, text: str, max_length: int, padding: str = "max_length",
                    return_attention_mask: bool = True, truncation: bool = True,
                    **_ignored) -> Dict[str, List[int]]:
        """HF-compatible subset used by the reference (refcoco.py:114-120)."""
        if padding == "max_length" and truncation and self.do_lower_case and text.isascii():
            nat = self._native_encoder()
            if nat is not None:
                ids_arr, n = nat.encode(text, max_length)
                out = {"input_ids": ids_arr.tolist()}
                if return_attention_mask:
                    out["attention_mask"] = [1] * min(n, max_length) + [0] * max(0, max_length - n)
                return out
        ids = self.encode(text, max_length=max_length, truncation=truncation)
        attn = [1] * len(ids)
        if padding == "max_length" and len(ids) < max_length:
            pad = max_length - len(ids)
            ids = ids + [self.vocab[self.PAD]] * pad
            attn = attn + [0] * pad
        out = {"input_ids": ids}
        if return_attention_mask:
            out["attention_mask"] = attn
        return out

    # -- decoding -------------------------------------------------------------------
    _SPECIALS = None

    def _special_ids(self):
        if self._SPECIALS is None:
            self._SPECIALS = {
                self.vocab[t] for t in (self.PAD, self.UNK, self.CLS, self.SEP, self.MASK)
                if t in self.vocab
            } - {self.vocab[self.UNK]}
        return self._SPECIALS

    @staticmethod
    def clean_up_tokenization(text: str) -> str:
        """HF's standard punctuation-spacing cleanup."""
        for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                     (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                     (" 're", "'re")):
            text = text.replace(a, b)
        return text

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True,
               clean_up_tokenization_spaces: bool = True) -> str:
        specials = self._special_ids()
        toks = [
            self.ids_to_tokens.get(int(i), self.UNK)
            for i in ids
            if not (skip_special_tokens and int(i) in specials)
        ]
        text = " ".join(toks).replace(" ##", "")
        return self.clean_up_tokenization(text) if clean_up_tokenization_spaces else text

    def batch_decode(self, seqs, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(s, skip_special_tokens=skip_special_tokens) for s in seqs]


def prepare_tokenizer(vocab_file: str = "", words: Optional[Iterable[str]] = None):
    """Reference prepare_tokenizer (decode.py:6-10): returns (tokenizer, BOS, EOS)."""
    if vocab_file:
        tok = WordPieceTokenizer.from_vocab_file(vocab_file)
    else:
        tok = WordPieceTokenizer.synthetic(words or DEFAULT_TEST_WORDS)
    start = tok.convert_tokens_to_ids(tok.cls_token)
    end = tok.convert_tokens_to_ids(tok.sep_token)
    return tok, start, end


DEFAULT_TEST_WORDS = (
    "the a an of on in left right man woman person dog cat car red blue green "
    "white black big small tall short wearing holding standing sitting next to "
    "front behind top bottom middle shirt hat table chair with and girl boy"
).split()
