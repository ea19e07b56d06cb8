"""The utilities of ROADMAP A4's third item (``utils/misc.py``,
``utils/typing.py``, ``utils/docstrings.py``, ``utils/cache.py``) and
``SmoothData1D`` against ``pde_tpu``'s, on the host; torch tensors stand
where ``pde_tpu`` takes JAX arrays."""

import json

import numpy as np
import pytest
import torch

import pde_tpu.utils.cache as jcache
import pde_tpu.utils.docstrings as jdoc
import pde_tpu.utils.math as jmath
import pde_tpu.utils.misc as jmisc
import pde_tpu.utils.typing as jtyping
import pde_tpu_torch as tpde
import pde_tpu_torch.utils.cache as tcache
import pde_tpu_torch.utils.docstrings as tdoc
import pde_tpu_torch.utils.math as tmath
import pde_tpu_torch.utils.misc as tmisc
import pde_tpu_torch.utils.typing as ttyping

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


@pytest.mark.parametrize("value", [3, 2.5, 4.0, 1 + 2j, "7", np.float64(2.0)])
def test_number(value):
    got, expected = tmisc.number(value), jmisc.number(value)
    assert got == expected and type(got) is type(expected)


@pytest.mark.parametrize("data", [[1, 2, 3], [1.5, 2], np.arange(4), [[1, 2], [3, 4]]])
def test_number_array(data):
    got, expected = tmisc.number_array(data), jmisc.number_array(data)
    np.testing.assert_array_equal(got, expected)
    assert got.dtype == expected.dtype
    np.testing.assert_array_equal(tmisc.number_array(torch.as_tensor(expected)), expected)


def test_common_dtype_and_namespace():
    assert tmisc.get_common_dtype(1, 2.0) == jmisc.get_common_dtype(1, 2.0)
    arrays = (np.ones(2, np.float32), np.ones(2, np.complex64))
    assert tmisc.get_common_dtype(*arrays) == jmisc.get_common_dtype(*arrays)
    tensors = (torch.ones(2, dtype=torch.float32), torch.ones(2, dtype=torch.complex64))
    assert tmisc.get_common_dtype(*tensors) == jmisc.get_common_dtype(*arrays)
    assert tmisc.get_array_namespace(torch.ones(2)) is torch
    assert tmisc.get_array_namespace(np.ones(2)) is np is jmisc.get_array_namespace(np.ones(2))


def test_decorators_and_descriptors():
    for misc in (jmisc, tmisc):

        class Shape:
            factor = 3

            @misc.preserve_scalars
            def double(self, x):
                return 2 * x

            @misc.classproperty
            def name(cls):
                return cls.__name__

            @misc.hybridmethod
            def kind(cls):
                return "class"

            @kind.instancemethod
            def kind(self):
                return "instance"

        assert Shape().double(2) == 4 and list(Shape().double(np.array([1, 2]))) == [2, 4]
        assert Shape.name == "Shape"
        assert Shape.kind() == "class" and Shape().kind() == "instance"

        @misc.decorator_arguments
        def tag(label="plain"):
            return lambda f: (label, f)

        assert tag(print)[0] == "plain" and tag("given")(print)[0] == "given"
        assert misc.module_available("numpy") and not misc.module_available("no_such_module")
        assert misc.import_class("collections.OrderedDict").__name__ == "OrderedDict"
        assert misc.estimate_computation_speed(lambda: None, test_duration=0.01) > 0


def test_hdf_write_attributes_and_directories(tmp_path):
    class Node:
        def __init__(self):
            self.attrs = {}

    results = []
    for misc in (jmisc, tmisc):
        node = Node()
        misc.hdf_write_attributes(node, {"a": [1, 2], "b": "x", "c": object()})
        results.append(node.attrs)
        with pytest.raises(TypeError):
            misc.hdf_write_attributes(Node(), {"c": object()}, raise_serialization_error=True)
        misc.ensure_directory_exists(tmp_path / misc.__name__ / "sub")
        assert (tmp_path / misc.__name__ / "sub").is_dir()
    assert results[0] == results[1] == {"a": json.dumps([1, 2]), "b": json.dumps("x")}


def test_typing_names():
    for name in ("Number", "NumberOrArray", "FloatingArray", "NumericArray", "ArrayLike",
                 "BackendType", "OperatorType", "OperatorNoBCType", "GhostCellSetter",
                 "VirtualPointEvaluator", "StepperType", "StepperHook"):
        assert hasattr(ttyping, name) and hasattr(jtyping, name)


def test_docstrings():
    assert set(tdoc.DOCSTRING_REPLACEMENTS) == set(jdoc.DOCSTRING_REPLACEMENTS)
    for doc in (jdoc, tdoc):

        def func():
            """Header.

                {ARG_TRACKER_INTERRUPT}
            """

        doc.fill_in_docstring(func)
        assert "{ARG_TRACKER_INTERRUPT}" not in func.__doc__
        assert "equidistant interrupts" in func.__doc__
        assert doc.get_text_block("WARNING_EXEC") == jdoc.get_text_block("WARNING_EXEC")
        assert doc.replace_in_docstring(func, "Header", "Title").__doc__.startswith("Title")


@pytest.mark.parametrize("obj", [1, "a", (1, [2, 3]), {"a": np.arange(3)}, {1, 2},
                                 np.linspace(0, 1, 4), None])
def test_hash_mutable(obj):
    assert tcache.hash_mutable(obj) == jcache.hash_mutable(obj)
    assert tcache.objects_equal(obj, obj) and jcache.objects_equal(obj, obj)


def test_hash_and_compare_tensors():
    arr = np.linspace(0, 1, 5)
    assert tcache.hash_mutable(torch.as_tensor(arr)) == jcache.hash_mutable(arr)
    assert tcache.objects_equal(torch.as_tensor(arr), arr)
    assert not tcache.objects_equal(torch.as_tensor(arr), arr + 1)


@pytest.mark.parametrize("method", ["none", "hash", "hash_mutable", "hash_readable", "json",
                                    "pickle"])
def test_serializers(method):
    value = {"a": [1, 2], "b": "c"} if method != "hash" else ("a", 1)
    got = tcache.make_serializer(method)(value)
    assert got == jcache.make_serializer(method)(value)
    if method in ("none", "json", "pickle"):
        assert tcache.make_unserializer(method)(got) == value


def test_cached_property_method_and_capacity():
    for cache in (jcache, tcache):

        class Counted:
            calls = 0

            @cache.cached_property
            def value(self):
                Counted.calls += 1
                return 5

            @cache.cached_method
            def scaled(self, factor, arr=None):
                Counted.calls += 1
                return factor * (0 if arr is None else sum(arr))

        obj = Counted()
        assert obj.value == obj.value == 5
        assert obj.scaled(2, arr=[1, 2]) == obj.scaled(2, arr=[1, 2]) == 6
        assert Counted.calls == 2
        d = cache.DictFiniteCapacity(capacity=2)
        d.update(a=1, b=2)
        d["c"] = 3
        assert list(d) == ["b", "c"]


@pytest.mark.parametrize("sigma", [None, 0.05, 0.3])
def test_smooth_data_1d(sigma):
    gen = np.random.default_rng(int(100 * (sigma or 1)))
    x = np.sort(gen.uniform(0, 2, 40))
    y = np.sin(3 * x) + 0.1 * gen.normal(size=40)
    expected, got = jmath.SmoothData1D(x, y, sigma), tmath.SmoothData1D(x, y, sigma)
    from_tensors = tmath.SmoothData1D(torch.as_tensor(x), torch.as_tensor(y), sigma)
    assert got.sigma == expected.sigma == from_tensors.sigma
    assert got.bounds == expected.bounds
    xs = np.linspace(-0.5, 2.5, 31)
    for smooth in (got, from_tensors):
        np.testing.assert_allclose(smooth(xs), expected(xs), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(smooth.derivative(xs), expected.derivative(xs), rtol=1e-12,
                                   atol=1e-12)
        assert smooth(0.7) == pytest.approx(expected(0.7), rel=1e-12)
    with pytest.raises(ValueError, match="same length"):
        tmath.SmoothData1D(x, y[:-1])
