"""PRISE-style BPE action tokenizer (counterpart of the JAX package's
``models/tokenizers/prise.py``, a copy of its own: the port imports nothing of
the JAX package). It maps discretized action-id sequences to "text" over the
ByteLevel alphabet, trains a BPE / WordPiece / Unigram subword model on it,
and encodes and decodes integer sequences.

A host-side component, as in the reference, which uses the Rust
``tokenizers`` package that ships with HuggingFace; the learned token ids
feed embedding tables on the device. ``tokenizers`` is imported when a
tokenizer is built, never when this module is imported.
"""


def _require_tokenizers():
    try:
        import tokenizers

        return tokenizers
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "PriseActionTokenizer needs the HuggingFace `tokenizers` package "
            "(installed with transformers), which is not importable here"
        ) from e


class PriseActionTokenizer:
    def __init__(self, algo="bpe", vocab_size=1000):
        tokenizers = _require_tokenizers()
        from tokenizers.pre_tokenizers import ByteLevel, WhitespaceSplit

        self.alphabet = sorted(ByteLevel().alphabet())
        self.char_index_map = {
            char: str(index) for index, char in enumerate(self.alphabet)
        }
        self.algo = algo
        self.vocab_size = vocab_size

        from tokenizers.models import BPE, Unigram, WordPiece
        from tokenizers.trainers import (
            BpeTrainer,
            UnigramTrainer,
            WordPieceTrainer,
        )

        if algo == "bpe":
            self._trainer_cls, model = BpeTrainer, BPE()
        elif algo == "wordpiece":
            self._trainer_cls = WordPieceTrainer
            model = WordPiece(unk_token="[UNK]", max_input_chars_per_word=100000)
        elif algo == "unigram":
            self._trainer_cls, model = UnigramTrainer, Unigram()
        else:
            raise NotImplementedError(algo)

        self.tokenizer = tokenizers.Tokenizer(model)
        if algo == "wordpiece":
            import tokenizers.decoders

            self.tokenizer.decoder = tokenizers.decoders.WordPiece()
        self.tokenizer.pre_tokenizer = WhitespaceSplit()

    # -------------------------------------------------- text bridging
    def to_alphabet(self, chars):
        return "".join(self.alphabet[c] for c in chars)

    def textualize(self, raw):
        assert isinstance(raw, list)
        if raw and isinstance(raw[0], int):
            raw = [raw]
        return " ".join(self.to_alphabet(word) for word in raw)

    def detextualize(self, text):
        text = " ".join(text.replace(" ", ""))
        decoded = "".join(
            self.char_index_map.get(char, char) for char in text
        )
        return [int(i) for i in decoded.split(" ")]

    # -------------------------------------------------- train / encode
    def train(self, corpus, min_frequency=2, max_token_length=10, verbose=False):
        corpus_text = self.textualize(corpus)
        trainer = self._trainer_cls(
            vocab_size=self.vocab_size,
            special_tokens=["[UNK]"],
            min_frequency=min_frequency,
            max_token_length=max_token_length,
        )
        self.tokenizer.train_from_iterator([corpus_text], trainer=trainer)
        vocab = self.tokenizer.get_vocab()
        self.vocab_size = len(vocab)
        if verbose:
            print(f"Learned vocab size: {len(vocab)}")

    def encode(self, raw):
        """list of original int ids -> list of token ids."""
        return self.tokenizer.encode(self.textualize(raw)).ids

    def decode(self, token_ids):
        """list of token ids -> list of original int ids."""
        return self.detextualize(self.tokenizer.decode(token_ids))
