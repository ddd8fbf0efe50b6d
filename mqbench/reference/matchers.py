"""Plain AMQP 0-9-1 exchange matchers, written from the specification.

Topic: a routing key and a binding pattern are words separated by ``.``;
in a pattern ``*`` stands for exactly one word and ``#`` for zero or more
words; a key reaches every queue bound with a pattern that matches it.
Headers: a binding's arguments are (header, value) pairs and ``x-match``
(``all``, the default, or ``any``); arguments whose name starts with
``x-`` are not pairs. ``all`` matches a message whose headers hold every
pair with an equal value, ``any`` one that holds at least one. Nothing
here imports the program or JAX.
"""

from __future__ import annotations


class TopicMatcher:
    """Topic bindings in a trie of pattern words."""

    def __init__(self) -> None:
        self.root: dict = {}

    def bind(self, pattern: str, queue: str) -> None:
        node = self.root
        for word in pattern.split("."):
            node = node.setdefault("next", {}).setdefault(word, {})
        node.setdefault("queues", set()).add(queue)

    def route(self, key: str) -> set:
        out: set = set()
        self._walk(self.root, key.split("."), 0, out)
        return out

    def _walk(self, node: dict, words: list, i: int, out: set) -> None:
        nxt = node.get("next", {})
        if i == len(words):
            out |= node.get("queues", set())
        else:
            for w in (words[i], "*"):
                child = nxt.get(w)
                if child is not None:
                    self._walk(child, words, i + 1, out)
        hash_ = nxt.get("#")
        if hash_ is not None:
            for j in range(i, len(words) + 1):
                self._walk(hash_, words, j, out)


class HeadersMatcher:
    """Headers bindings, each tested in turn."""

    def __init__(self) -> None:
        self.bindings: list = []

    def bind(self, queue: str, arguments: dict) -> None:
        mode = arguments.get("x-match", "all")
        pairs = {k: v for k, v in arguments.items()
                 if not k.startswith("x-")}
        self.bindings.append((queue, mode, pairs))

    def route(self, headers: dict) -> set:
        out = set()
        for queue, mode, pairs in self.bindings:
            hits = [k in headers and headers[k] == v
                    for k, v in pairs.items()]
            if (all(hits) if mode == "all" else any(hits)):
                out.add(queue)
        return out
