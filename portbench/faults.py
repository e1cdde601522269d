"""Faults planted in the program under test, to show that the check
catches them.  Each is a context manager that patches one of the port's
classes for as long as it is open, and each is a fault a later change
could bring in by mistake:

* ``answer_altered``: one answer of every request changed where it is
  produced (the first anchor's label of every served bucket; the first
  row of every class map, as a band edge out by one would);
* ``state_unchanged``: a training step that leaves the parameters and the
  optimizer's state as they were;
* ``half_batch``: a training step that leaves out the second half of every
  batch and takes the mean over the rest.

The training faults are planted in both programs classes the training
entry builds (``DensePrograms`` for a dense model, ``DualPrograms`` for a
dual one): whichever the run builds carries the fault.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(cls, name: str, make):
    original = getattr(cls, name)
    setattr(cls, name, make(original))
    try:
        yield
    finally:
        setattr(cls, name, original)


def _patched_all(*patches) -> contextlib.ExitStack:
    """Each ``(cls, name, make)`` patched until the stack is closed."""
    stack = contextlib.ExitStack()
    for cls, name, make in patches:
        stack.enter_context(_patched(cls, name, make))
    return stack


def answer_altered(classes: int):
    from dmfusion_torch.export import TorchClassifier

    def predict(original):
        def wrapped(self, *inputs):
            out = original(self, *inputs).clone()
            out[0] = (out[0] + 1) % classes
            return out
        return wrapped

    def class_map(original):
        def wrapped(self, ms, pan):
            out = original(self, ms, pan).clone()
            out[0] = (out[0] + 1) % classes
            return out
        return wrapped

    return _patched_all((TorchClassifier, "predict", predict),
                        (TorchClassifier, "class_map", class_map))


def state_unchanged():
    from dmfusion_torch.train.steps import DensePrograms, DualPrograms

    def step(original):
        def wrapped(self, pooled, scene_args, ids_b, labels_b, mask_b):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self._loss(pooled, scene_args, ids_b, labels_b, mask_b)
            return loss.detach()
        return wrapped

    def train_step(original):
        def wrapped(self, inputs, labels_b, mask_b=None, count=None):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(self.model(*inputs), labels_b, mask_b, count)
            return loss.detach()
        return wrapped

    return _patched_all((DensePrograms, "_step", step),
                        (DualPrograms, "train_step", train_step))


def half_batch():
    from dmfusion_torch.train.steps import DensePrograms, DualPrograms

    def train_epoch(original):
        def wrapped(self, scene_args, ids, labels, mask):
            mask = mask.clone()
            mask[:, mask.shape[1] // 2:] = 0
            return original(self, scene_args, ids, labels, mask)
        return wrapped

    return _patched_all((DensePrograms, "train_epoch", train_epoch),
                        (DualPrograms, "train_epoch", train_epoch))


#: The faults each traffic entry can have.
BY_ENTRY = {"predict_ids": ("answer_altered",),
            "class_map": ("answer_altered",),
            "train_epoch": ("state_unchanged", "half_batch")}


def plant(name: str, classes: int):
    if name == "answer_altered":
        return answer_altered(classes)
    return {"state_unchanged": state_unchanged,
            "half_batch": half_batch}[name]()
