"""The traffic generator: a frozen copy of the port's
``data/synthetic.py:HeteroLMDataset`` (heterogeneous per-client token
streams from a seed), and the pool of round batches a cell cycles through.

Each client draws from its own first-order Markov chain: its unigram
logit table mixes a shared base table with a client-unique one
(``heterogeneity`` 0 = IID, 1 = disjoint), and token t+1 is drawn from
``roll(table, token_t) + table``. Batches are ``[tau, clients, batch,
seq]`` int32, drawn with ``torch.Generator``s on the device."""

from __future__ import annotations

import dataclasses

import torch

_ROUND_STRIDE = 1_000_003  # keeps per-round seeds of adjacent seeds apart


@dataclasses.dataclass(frozen=True)
class HeteroLMDataset:
    vocab_size: int
    n_clients: int
    seq_len: int
    batch_size: int          # per client
    heterogeneity: float     # in [0, 1]
    seed: int = 0
    device: str = "cpu"

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _client_logits(self) -> torch.Tensor:
        """[clients, vocab] per-client unigram logit tables."""
        base = torch.randn((self.vocab_size,), generator=self._gen(self.seed),
                           device=self.device)
        uniq = torch.randn((self.n_clients, self.vocab_size),
                           generator=self._gen(self.seed + 1),
                           device=self.device)
        h = self.heterogeneity
        return (1.0 - h) * base[None, :] + h * 2.0 * uniq

    def sample_round(self, round_index: int, tau: int) -> torch.Tensor:
        """Tokens [tau, clients, batch, seq] for one round; every (client,
        sequence) chain is sampled at once, one position per step."""
        logits = self._client_logits()                        # [C, V]
        gen = self._gen((self.seed + 2) * _ROUND_STRIDE + round_index)
        C, V, S = self.n_clients, self.vocab_size, self.seq_len
        n = tau * self.batch_size
        vocab = torch.arange(V, device=self.device)

        def draw(lg):  # categorical over the last axis (Gumbel-max)
            u = torch.rand(lg.shape, generator=gen, device=self.device)
            return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)

        tok = draw(logits[:, None, :].expand(C, n, V))        # [C, n]
        toks = [tok]
        for _ in range(S - 1):
            idx = (vocab[None, None, :] - tok[..., None]) % V  # [C, n, V]
            shifted = torch.gather(logits[:, None, :].expand(C, n, V), 2, idx)
            tok = draw(shifted + logits[:, None, :])
            toks.append(tok)
        seqs = torch.stack(toks, dim=-1)                      # [C, n, S]
        seqs = seqs.reshape(C, tau, self.batch_size, S).transpose(0, 1)
        return seqs.contiguous().to(torch.int32)


def round_pool(mix: dict, vocab_size: int, seed: int, device) -> list:
    """``mix["distinct_rounds"]`` round batches ``[tau, clients, batch,
    seq]``: entry 0 feeds the warm-up aggregation (its first local batch),
    entries 1, 2, ... the rounds, cycling after the last."""
    ds = HeteroLMDataset(vocab_size=vocab_size, n_clients=mix["n_clients"],
                         seq_len=mix["seq_len"], batch_size=mix["batch"],
                         heterogeneity=mix["heterogeneity"], seed=seed,
                         device=str(device))
    return [ds.sample_round(r, mix["tau"])
            for r in range(mix["distinct_rounds"])]


def round_batch(pool: list, r: int) -> torch.Tensor:
    """The tokens of round ``r`` (0-based, counted from the first round
    after the warm-up aggregation)."""
    return pool[1 + r % (len(pool) - 1)]
