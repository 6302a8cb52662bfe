"""What the reference follows of the program's own state, recorded in the
timed path without a synchronisation: the token that each heatmap
explains, and what a family's ``Recorder`` adds (Mixtral: its routing).

A heatmap of ``AttributionPipeline.__call__`` explains the argmax of the
next-token logits. At full depth in bf16 the program's logits part from
the float32 reference's by up to half a logit, so the two argmaxes differ
wherever the best tokens lie that close, and the reference's map of
another token would judge the wrong thing. The reference therefore
explains the program's token; how far that token's logit lies below the
reference's best is ``logit_gap``.
"""

import contextlib


class Explained:
    """With it entered, every ``AttributionModel._row`` target (the logits
    row that ``__call__`` takes the maximum of) also keeps the row's argmax,
    ``[B]`` on the device: the index ``max`` takes, the first of equal
    values. :meth:`take` gives the last call's, one per prompt."""

    def __init__(self):
        self.tokens = []

    def __enter__(self):
        from lxt_tpu_torch.models import registry
        self._cls, self._row = registry.AttributionModel, registry.AttributionModel._row
        original, sink = self._row, self.tokens

        def _row(model, run, position):
            row = original(model, run, position)

            def recorded(e):
                logits = row(e)
                sink.append(logits.detach().argmax(-1))
                return logits
            return recorded

        self._cls._row = _row
        return self

    def __exit__(self, *exc):
        self._cls._row = self._row

    def take(self, prompts, keep):
        """The last call's token of each of its prompts ``keep``
        (``{j: token}``, None where it recorded none)."""
        last, self.tokens[:] = (self.tokens[-1] if self.tokens else None), []
        if last is None or last.shape[0] < len(prompts):
            return dict.fromkeys(keep)
        return {j: last[j].clone() for j in keep}


class Recording(contextlib.ExitStack):
    """The explained tokens and the family's recorder, if it has one;
    :meth:`take` gives each kept prompt of the last call its state, a dict
    ``{"token", and the family's keys}``, and lets go of the others'."""

    def __init__(self, family, config):
        super().__init__()
        self.explained = Explained()
        self.family = family.Recorder(config) if hasattr(family, "Recorder") else None

    def __enter__(self):
        super().__enter__()
        self.enter_context(self.explained)
        if self.family is not None:
            self.enter_context(self.family)
        return self

    def take(self, prompts, keep=()):
        """``{j: state}`` of the last call's prompts ``keep`` (indices)."""
        tokens = self.explained.take(prompts, keep)
        extra = self.family.take(prompts, keep) if self.family is not None else {}
        return {j: dict(token=tokens[j], **(extra.get(j) or {})) for j in keep}
