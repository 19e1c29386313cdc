"""Composable experiment and search spaces, the port's copy of
``pygim_tpu/tune/space.py``.

``For(name, values)`` is an axis; ``*`` forms the cartesian product (duplicate field names rejected);
``+`` concatenates spaces over identical field sets; ``Table`` holds an
explicit list of points; ``Unit`` is the product identity. Iteration yields
plain dicts.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Sequence


class Space:
    """Base: iterable of dict config points with a fixed field set."""

    fields: tuple

    def __iter__(self) -> Iterator[dict]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __mul__(self, other: "Space") -> "Space":
        return Product(self, other)

    def __add__(self, other: "Space") -> "Space":
        return Concat(self, other)


class Unit(Space):
    """Product identity: one empty point."""

    fields = ()

    def __iter__(self):
        yield {}

    def __len__(self):
        return 1


class For(Space):
    """One named axis."""

    def __init__(self, name: str, values: Sequence[Any]):
        self.name = name
        self.values = list(values)
        self.fields = (name,)

    def __iter__(self):
        for v in self.values:
            yield {self.name: v}

    def __len__(self):
        return len(self.values)


class Product(Space):
    """Cartesian product; field sets must be disjoint (space.py duplicate
    check)."""

    def __init__(self, a: Space, b: Space):
        dup = set(a.fields) & set(b.fields)
        if dup:
            raise ValueError(f"duplicate fields in product: {sorted(dup)}")
        self.a, self.b = a, b
        self.fields = tuple(a.fields) + tuple(b.fields)

    def __iter__(self):
        for pa in self.a:
            for pb in self.b:
                yield {**pa, **pb}

    def __len__(self):
        return len(self.a) * len(self.b)


class Concat(Space):
    """Union of two spaces over the same fields (space.py equal-field
    check)."""

    def __init__(self, a: Space, b: Space):
        if set(a.fields) != set(b.fields):
            raise ValueError(
                f"concat requires equal fields: {a.fields} vs {b.fields}"
            )
        self.a, self.b = a, b
        self.fields = a.fields

    def __iter__(self):
        yield from self.a
        yield from self.b

    def __len__(self):
        return len(self.a) + len(self.b)


class Table(Space):
    """Explicit list of points (space.py Table.from_dicts)."""

    def __init__(self, rows: Sequence[dict]):
        rows = [dict(r) for r in rows]
        if rows:
            fields = set(rows[0])
            for r in rows:
                if set(r) != fields:
                    raise ValueError("inconsistent fields in Table rows")
            self.fields = tuple(sorted(fields))
        else:
            self.fields = ()
        self.rows = rows

    @classmethod
    def from_dicts(cls, rows: Iterable[dict]) -> "Table":
        return cls(list(rows))

    def __iter__(self):
        yield from (dict(r) for r in self.rows)

    def __len__(self):
        return len(self.rows)
